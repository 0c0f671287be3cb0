#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It imports only
``complex_prompt_diffusion_tpu_torch`` (never jax or the JAX package) and:

  phase 0  builds the hand-written CUDA kernels from ``csrc/`` (nvcc, one
           process per source, in parallel), and checks in their SASS
           (``cuobjdump``) that the Hopper bodies of K1, K2, K4 and K5
           (``attention_sm90.cu``, ``attention_bf16_wide_sm90.cu``,
           ``attention_f32_sm90.cu``, ``attention_f32_fused_sm90.cu``,
           ``geglu_ff_sm90.cu``, ``geglu_ff_f32_sm90.cu``, ``conv3x3_sm90.cu``,
           ``conv3x3_f32_sm90.cu``, ``attention_cm_sm90.cu``,
           ``attention_cm_f32_sm90.cu``), of K6
           (``winograd_sm90.cu``, ``winograd_f32_sm90.cu``) and of K7
           (``probe_attention*.cu``: K1's and K5's Hopper loops and the fused
           f32 body in its modes) hold wgmma (HGMMA) and TMA load (UTMALDG)
           instructions in every instantiation (K7's loads-only mode, which
           computes nothing, TMA loads alone; K2's, K4's and K6's f32 bodies
           TF32 wgmma only), and K3's and K8's (``groupnorm_sm90.cu``,
           ``probe_groupnorm.cu``: K3's kernels in K8's modes) and K9's
           (``probe_copy_sm90.cu``) a TMA or bulk-copy load (UTMALDG or
           UBLKCP) in every one, K8's tensor-core statistics HMMA;
  phase 1  runs each kernel at its paths' shapes against its plain PyTorch
           twin on the card (TF32 off): error, the times (CUDA-graph
           replays, ``tools/hotcold.py``, one input repeated) of the kernel,
           the body it replaced where it is still built (K1's and K4's
           mma.sync bodies, K1's f32 FMA body, K3's, K5's, K6's, K7's, K8's
           and K9's first bodies; held to the same twin), the
           twin and the one
           PyTorch call that computes the same function (where there is
           one), and the bound from this case's bytes and flops, with the
           bound's share of the kernel's time (for the 3xTF32 bodies the
           FMA rate's bound beside it); the sums over the 22 convs
           of a batch-1 UNet call (bf16 and f32), over the 16 GEGLU FF
           calls of a b4 step (bf16 and f32) and of a b1 step (f32), and
           over the 61 GroupNorms of a b4 and of a b1 step; the host cost
           of one TMA tensor-map encode and of one call of the K1, K2, K4
           and K5 wrappers;
  phase 2  the main path: SD-1.5 at full width with random weights from a
           seed, txt2img at 512x512, batch 4, DDIM eta=0, CFG 7.5, then the
           exact-f32 VAE decode to uint8;
  phase 3  holds the kernel path to the plain path on small inputs at full
           width: one UNet eval (CUDA kernels vs the plain twins on CPU
           copies of the same weights), the f32 VAE decode, and the bf16
           VAE decode and encode;
  phase 4  the batch-1 render: txt2img at 512x512, batch 1, DDIM, CFG 7.5,
           bf16 VAE decode (``cast_vae("bfloat16")``): seconds to first
           image, s/step, decode ms, peak memory;
  phase 5  the bf16 VAE decode of phase 2's latents at batch 4, against
           their f32 decode;
  phase 6  img2img (DDIM, strength 0.75) of a phase-2 image at batch 1;
  phase 7  the k-diffusion render: txt2img at 512x512, batch 4, DPM++ 2M on
           the Karras schedule, 20 steps, CFG 7.5, the UNet's channel-major
           attention route on (``attn_route="cm"``: K5's bf16 body at
           levels 1 and 2), f32 decode; and one UNet eval with that route
           held against the same eval without it; then the UNet's 10 cm
           sites, each through the cm block against the default route on
           one input: in bf16 (K5's bf16 body against K1's sm90 body) and
           with the weights cast to f32 (K5's f32 body against K1's fused
           3xTF32 body); the sites' launches count as a path of their own;
  phase 8  k-family img2img at batch 1 (Euler Ancestral, strength 0.75: 6 of
           20 steps) with the canonical-K attention route switched on for
           the phase (K5's bf16 body at every self-attention site), bf16
           VAE;
  phase 9  the Winograd probe (K6), which no layer dispatches, called as
           its user would call it: on the weights of the UNet's 20 ResBlock
           convs of the 32x32 and 16x16 planes at UNet batch 2, each held
           against the same conv through ``layers.conv2d`` (K4): in bf16 on
           K6's Hopper body, in f32 on its 3xTF32 body (the kernels their
           plans predict), the f32 ones also against the plain twin at 1e-5
           (TF32 off); then the 20 convs of each dtype timed on K6's Hopper
           body, on its first body, through K4 and through cuDNN;
  phase 10 the probes of the TPU tuning scripts (``scripts/perf_attn8..12``,
           ``perf_gn4..8``), which no layer dispatches: every mode and flag
           of K7 (attention ablations), K8 (GroupNorm modes, tensor-core
           statistics, forced splits) and K9 (streaming copy), and of K7's,
           K8's and K9's replaced bodies, against its plain twin at small
           shapes, K7's full mode at K1's choices bit-exact against K1, K8's
           full mode at K3's plan bit-exact against K3, and every K9
           mode at the copy scripts' shapes bit-exact on both of K9's
           bodies; the SASS wgmma count of every K7 mode (and the replaced
           loops' HMMA) and the statistics of every GroupNorm mode
           (``cuobjdump``); then every script variant timed at the scripts'
           shapes with the L2 hot and cold, K7's, K8's and K9's replaced
           bodies beside their rows, and each K7 mode's share of the full mode's
           time at every UNet level (``tools/probe_attention.py``,
           ``tools/probe_groupnorm.py``);
  phase 11 the exact-f32 render: one SD-1.5 UNet eval cast to f32 on a
           16x16 latent against the plain twins on CPU copies (TF32 off);
           txt2img at 512x512, batch 1, DDIM, CFG 7.5 with the UNet in f32
           (``bundle.cast("float32")``: K2's and K4's 3xTF32 bodies, K1's
           fused 3xTF32 body), then the f32 decode: seconds to image,
           s/step, decode ms, peak memory; and a short txt2img of the
           default bundle, ``ModelBundle.random()`` with no arguments (the
           tiny config, f32 UNet: K4's 3xTF32 body at 32 -> 32 and 96 -> 32,
           its narrow bodies at conv_in and the out conv, none on the
           generic body), a path of its own;
  phase 12 the sampler zoo (run after phase 8, on phase 2's bundle with the
           bf16 VAE): txt2img at 512x512, batch 1, CFG 7.5, 20 steps, once
           with each of PLMS, DPM-Solver++ multistep order 2, singlestep
           order 3 and adaptive order 3, UniPC bh2 order 2 (twice with one
           seed: the same bits) and vary_coeff order 3, iPNDM, DPM Adaptive
           and Blur, then the bf16 decode; and a DDIM inversion round trip
           (``ddim_encode`` of a phase-2 image's latents over 20 steps, DDIM
           20 back: the latent relRMSE). Each render counts its UNet calls
           (a wrapper around ``models.unet_apply``) against the NFE its
           sampler's code implies (PLMS steps + 1; the fixed-grid solvers,
           UniPC, iPNDM and Blur steps; the adaptive integrators 3 an
           iteration, at most 200 iterations, printed) and prints seconds a
           render and a UNet call;
  phase 13 SD 2.1-v at full width, 768x768 (after phase 11): random SD 2.1
           trees from seed 0 written as a CompVis fp16 checkpoint
           (``tools/synth_checkpoint.py``, in a temporary directory, deleted
           after) and loaded through ``config.bundle_from_config`` with a
           literal of v2-inference-v.yaml's model section (the card has no
           PyYAML), the UNet cast to bf16 on the host, held bit for bit to
           what was written; txt2img b4 DDIM 50 CFG 7.5 with the exact-f32
           decode (peak memory); txt2img b1 DPM++ 2M Karras 20 (the v
           denoiser) with the bf16 decode (seconds to first image); one
           UNet eval on a 24x24 latent (S = 576, 144, 36, 9) against the CPU
           plain twins. Phase 1 holds SD 2.1's kernel rows too: K1 at head
           dim 64 and S = 9216, 2304, 576, 144, the d512 mid-block at S =
           9216 (bf16 b1, f32 b4), K2 at M73728, K3 on the 96^2 and 768^2
           planes, K4 on 24^2;
  phase 14 the prompt algebra (after phase 12, on phase 2's bundle with the
           bf16 VAE, 512x512): (a) the schedule grammar's table on the
           card's host, with no lark loaded; (b) a 3-factor
           CompositionalPrompt (main prompt, an AND factor on the left half
           at scale 1.5, a NOT factor off the top third at 0.5) at b1, DDIM
           20, with uc blur (k 7, 5 rounds), eps dynamic thresholding, the
           dynamic scale clip and clip_sample: UNet batch 4, so K4 takes
           the 22 convs a call; one guided eps of the same spec at a 16x16
           latent held to the CPU plain twins; (c) the same spec at b4,
           DDIM 10: UNet batch 16 (K1 over 128 head batches at S = 4096,
           K2 at M = 65536, K3 at N = 16, no K4), peak memory; (d) the
           manager's JSON API: process_txt2img of a WeightedPrompt ("a
           cat:2.0 a dog:1.0", both subprompts in one CLIP batch) with DPM++
           2M Karras 20 and a score corrector, and process_img2img of a
           phase-2 image with a mask through RePaint (steps 10, jump_length
           5, jump_n_sample 2; UNet calls from the jump walk); (e)
           RenderEngine.render_path of a ComplexPrompt with a prompt lerp
           (lerp_keys ["magnitude"]): 3 independent frames at b1, DDIM 10,
           then 2 feedback frames. Every path's K1-K4 launches equal
           ``unet_call_launches`` at its UNet batch (1 + K) x B times its
           UNet calls. Phase 1 holds every distinct K1-K4 shape of a UNet
           call at UNet batch 4 and 16 to its plain twin and times it
           (kernel_cases' "ub4" and "ub16" groups, from
           ``unet_batch_shapes``), with the step sums of K2, K3 and K4;
  phase 15 concat-conditioned UNets at 512x512 (after phase 13): (a) a
           9-channel SD-1.5 inpaint checkpoint (random weights from seed 0,
           fp16, written in the run and loaded by
           ``ModelBundle.from_checkpoint``, held bit for bit to what was
           written; ``UNetConfig.sd_inpaint``; UNet bf16, bf16 VAE):
           ``inpaint`` of a phase-2 image b1 DDIM 50 and b4 DPM++ 2M Karras
           20, the manager's ``process_img2img`` with a mask (its 9-channel
           branch, DDIM 20), a 2-factor CompositionalPrompt (UNet batch 3,
           DDIM 20; phase 1's "ub3" group holds its shapes); (b) a
           5-channel SD-2 depth checkpoint loaded by
           ``config.bundle_from_config`` with a literal of
           v2-midas-inference.yaml's model section (``UNetConfig.sd2_depth``,
           eps): ``depth2img`` (Sobel depth) strength 0.75, DDIM 50, b1 with
           the bf16 VAE and b4 (four images, one depth map each) with the
           exact-f32 one; for each UNet, one guided eps on a 16x16 latent
           with its concat channels (conv_in's C = 9 or 5 on K4's narrow-C
           body) against the CPU plain twins; (c) the native tokenizer
           built by the host C++ compiler, its ids equal to the Python BPE
           tokenizer's over a fixed corpus on a synthetic byte-level vocab
           (``tools/synth_vocab.py``). Every render's
           K1-K4 launches equal ``unet_call_launches`` of the loaded config
           at its UNet batch times its calls. Phase 1 holds SD-2's 512^2
           shapes too (kernel_cases' "sd2_512" group: K1 at head dim 64 and
           S = 4096, 1024, 256 at UNet batch 2 and 8, and at the middle
           block's 64 tokens; K4's narrow-C body on the concat UNets'
           conv_in at a 32x32 latent, 9 -> 320 and 5 -> 320, bf16 and f32);
  phase 16 the UNet's opt-in modes (after phase 15, on phase 2's bundle
           rebuilt from seed 0: bf16 UNet, bf16 VAE, 512x512 unless said):
           (a) a UNet-batch-8 call returning its skips, decoder features
           and deep feature, then injecting them back (torch.equal), a
           ``collect_attn_maps`` call at UNet batch 2 (16 maps [2, 8, HW,
           77] whose rows sum to 1; the output against the plain call) and
           a DAAM ``word_heat_map``; (b) DeepCache at b4: DDIM 50 at
           interval 3 (17 full, 33 shallow calls) and DPM++ 2M Karras 20 at
           interval 2, against the exact renders of the same seed (s/step,
           latent relRMSE), and a shallow pass fed the same call's deep
           feature against the full pass (torch.equal); (c) token
           reduction: ToDo 0.75 at b4 DDIM 50, with DeepCache 3 too, ToMe
           merge 0.75 (b1 DDIM 50) and 0.3 (b1 DDIM 20, S' = 2868) with
           ``tome_mlp`` and ``tome_crossattn`` (s/step, relRMSE, uint8
           PSNR and SSIM against the exact renders: random weights), and the
           merged level-0 attention (K1) and FF (K2) against their plain
           twins under one plan; (d) attention-saliency guidance b1 DDIM
           50 (4 guided rounds: 54 UNet calls, 4 at UNet batch 1), and one
           guided eps with the UNet in f32 at a 16x16 latent against the CPU
           plain twins; (e) tiled inference: 1024x1024 b1 DDIM 20, 64-latent
           tiles every 48, 2 a call (UNet batch 4), and a single tile at
           512x512 equal to the untiled render. Every render's K1-K4 launches
           follow from its UNet calls by kind (full, shallow, uncond-only,
           tile chunk; ``unet_call_launches`` with ``deep_at`` and the
           config's token reduction). Phase 1 holds the new shapes too
           (kernel_cases' "todo" and "tome" groups: K1 at Sq 4096, Skv 1024
           at UNet batch 8 and 2; at S' = 1024 and 2868; K2 at M = 2 x S';
           "ub1": attention guidance's UNet-batch-1 call);
  phase 17 gradients through the kernels (after phase 16; phase 2's bundle
           rebuilt from seed 0): (a) every body a dispatch entry reaches (K1
           sm90, fused f32, 3xTF32 f32 and bf16 wide; K5 bf16 and f32; K2
           bf16 with f32 master weights and f32; K3 bf16 and f32, with and
           without SiLU; K4 sm90, f32 and generic; K6 bf16 and f32) under
           grad: the forward launches the planned kernels with the bits of a
           call without grad, the backward launches none, and the gradients
           for a random cotangent torch.equal autograd's through the plain
           twin, each in its input's dtype (None where an input needs none);
           K7-K9 still raise under grad; (b) the SD-1.5 train step at full
           width: f32 master weights, bf16 compute, batch 2 at 512x512, a
           random context, Adan (lr 1e-4) and LitEma, 3 steps (s/step, peak
           memory; each step's K1-K4 launches as its UNet call predicts, one
           step's gradients all finite and its backward launching nothing),
           then one step in f32 at a 16x16 latent, its loss and the
           gradients of conv_in, a K4-gated conv, a GEGLU w1, a GroupNorm
           scale and a self-attention wq against CPU copies (1e-4); (c)
           null-text inversion of a phase-2 image at 512x512 (DDIM 20, 5
           Adam iterations a step, CFG 7.5 at UNet batch 2): wall time, the
           table [20, 1, 77, 768] finite, the mean DDIM-step loss lowered;
           (d) the "Log" sampler through ``sample_latents``: RK4 4 steps at
           512x512 b1 (16 VJPs) and dopri5 at a 16x16 latent over the
           last 3 of 20 sigmas (NFE printed; the whole range, 1267 VJPs,
           took 360 s), finite log-likelihoods [B]. The kernels line names
           each kernel's backward rule;
  phase 18 CLIP guidance and hypernetworks (after phase 17; phase 2's
           bundle rebuilt from seed 0: UNet bf16, VAE f32; 512x512): (a) the
           guide CLIP's vision towers (ViT-B/32, ViT-L/14; random weights,
           b4 224^2) and SD-1.5's text tower at "pooled" and "hidden"
           (layer_idx 11), f32 with TF32 off, against the CPU port; (b)
           ``sample_latents(clip_guidance=)`` with a ViT-B/32 guide and a
           unit random 512-wide text embedding: DDIM 20 b1 against the
           unguided render of the same start (the latents move), and PLMS
           10 on a 2-factor prompt at factor_limit 2 (11 evaluations: CFG at
           UNet batch 3, the guide at 2); (c) ``clip_guided_txt2img`` with a
           ViT-L/14 guide, 4 cutouts and SD-1.5's pooled text embedding
           (768 = 768), DDIM 20 b1, uint8 images; (d) txt2img b1 DDIM 20 with
           a random hypernetwork (k and v, hidden 1536) on the 16
           cross-attention sites, k/v hoisted once; (e) one CLIP-guided eps
           with the UNet and VAE in f32 at a 16x16 latent (1e-4) and one f32
           hypernetwork UNet eval (1e-5) against the CPU port. Every path
           prints s/step and peak memory; its UNet calls by batch and its
           K1-K4 launches equal what its calls' and decodes' forwards
           predict (``check_calls(f32_decodes=)``), so no backward launched
           a kernel;
  phase 19 animation, noise inversion and the rest of the VAE (after phase
           18; phase 2's bundle rebuilt from seed 0: UNet bf16, VAE cast to
           bf16; 512x512): (a) ``render_animation`` b1, 4 frames of DDIM 20
           at strength 0.5 (later frames: t_start 10), CFG 7.5, angle, zoom
           and pan keyframes, the perspective flip on the last frame, a 3D
           warp over the Sobel depth of frame 0: each frame's warp, colour
           match, encode, s/step and decode; its UNet calls (50 at UNet batch
           2) and K1-K4 launches as ``unet_call_launches`` and its 4 decodes
           and 3 encodes predict; the card's colour match and warps
           (``utils/cv.py``) against the same functions on the CPU on the
           same inputs (at least 99.9% of the values equal, none more than 1
           level off); (b) ``find_noise_for_image`` of frame 0's latents over
           21 ascending sigmas at CFG 2 (20 UNet calls = NFE); (c) the VQ
           round trip at ``VAEConfig.sd()`` with 16384 codes (encode,
           quantize, decode ms, peak memory, every code in range); (d)
           ``vae_decode_tiled`` of a 128x128 latent (1024x1024, 9 tiles)
           against the untiled decode (ms, peak memory, max abs and PSNR:
           reported, not gated); (e) ``boost_depth`` of frame 0 with the
           Sobel estimator (host). Phase 1 holds the untiled 1024x1024
           decode's shapes (kernel_cases' "vae1024" group: K1's wide body at
           S = 16384, K3 on its decoder planes);
  phase 20 the port's last modules (after phase 19; phase 2's bundle rebuilt
           from seed 0, bf16 VAE): (a) a random SD-1.5 UNet written as a
           diffusers state dict (fp16, ``tools/synth_checkpoint.py``) and
           read by ``params.convert_unet_diffusers``, against the same tree
           under CompVis keys read by ``convert_unet``: the trees bit-equal
           and the two txt2img renders (512x512 b1 DDIM 20, bf16 decode)
           torch.equal; (b) T5 v1.1-large (24 layers, f32, TF32 off, random
           weights) over [4, 77] tokens, its first row against the CPU port
           (1e-4), and ``clip_t5_encode`` with SD-1.5's CLIP; (c) ``kl`` and
           ``nll`` of the bf16 encoder's 512x512 posterior against the CPU on
           the same moments; (d) two ranks spawned on cuda:0 (gloo, NCCL
           refuses two ranks on one device; ``file://`` rendezvous): rank 0
           builds the bundle and ``parallel.replicate`` broadcasts it; TP at
           model 2 (``shard_bundle``): one bf16 UNet eval against the
           unsharded one (2e-2), the same eval in f32 with the biases drawn
           nonzero against the unsharded f32 eval (1e-4), and txt2img
           512x512 b1 DDIM 10 against the one-rank render (relRMSE 0.1), 48
           all-reduces a UNet call, each rank's K1-K4 launches as predicted
           at 4 heads and half the hidden width; DP at data 2: each rank's
           image of a b2 render, no all-reduce, torch.equal to the one-rank
           b1 render of its x_T slice, the latents gathered through the
           host. The ranks report their counts to the parent
           (``launches_by_path``); a failed rank fails the spawn. Phase 1
           holds a TP rank's shapes (kernel_cases' "tp2" and "tp4" groups:
           K1 at B2 H4 and H2, S4096 / 1024 / 256, d40 / 80 / 160; K2 at
           H4 = 640 / 1280 / 2560 and 320 / 640 / 1280; bf16 and f32);
  phase 21 the JAX package's last forms (after phase 14, on phase 2's
           bundle): (a) the exact subpixel upsample conv forced
           (``layers._SUBPIXEL_UP = "1"``) against off: one bf16 UNet call
           at UNet batch 2, the b1 decode in bf16 and in f32: relRMSE and
           ms of each form, the forced calls' launches; (b) DPM-Solver
           classifier guidance (``model_wrapper(guidance_type=
           "classifier")``) on a 16x16 latent, the SD-1.5 UNet cast to f32
           and a classifier on K4, K3 and K1: one guided eps (1e-4), its
           guidance term and a 5-step DPM-Solver++ 2M sample (1e-3) against
           the CPU, the launches the UNet calls and the classifier's
           forwards predict, none in its backwards;
  phase 22 a UNet at CompVis LDM-VQ-4's widths (after phase 20; the
           celebahq-ldm-vq-4.yaml UNet params typed into this script and
           mapped by ``config.unet_config_from_yaml``: 224 / 448 / 672 / 896
           channels, up-path concats 672 .. 1792, head dim 32, 3 channels
           on a 64x64 latent, no context; random weights from seed 22): (a)
           one bf16 UNet call at UNet batch 2 (up path fused) and one f32
           call at UNet batch 1 against the plain twins on CPU copies (TF32
           off; 5e-2, 1e-4); (b) DDIM 20 steps at batch 4 in bf16, timed
           cold (s/step, peak memory); (c) every path's launches as its
           calls predict (``check_ldm``: K1 twice a self-attention site,
           attn2 attending to its own tokens; K4's 28 (bf16) or 22 (f32)
           gated convs a call, C or Co 32 mod 64 among them, all on the
           Hopper body of the dtype, none on the generic one); (d) K6 on the
           20 ResBlock convs of the 32^2 and 16^2 planes in both dtypes
           against K4 and the f32 twin, none on its first body, timed as
           phase 9 times its convs. Phase 1 holds its shapes (kernel_cases'
           "ldm_vq4" group at UNet batch 2 and 4; K4 f32 at UNet batch 1 and
           2; K6 at 32x32 672->448, 16x16 448->672 and 672->672) with the
           PR-2 body (``csrc/conv3x3.cu``) beside each K4 case and the conv
           sums of each call.

The up path's skip concat is fused in every bf16 UNet call at UNet batch
<= 4 (``models.unet.skip_cat_fused``): its 12 up-path GroupNorms run K3's
two-source form (``group_norm_cat``, counted into K3's 61 calls a UNet call
too: its slab form, ``group_norm_cat_slab``, one kernel a call on the 7
pairs of the 8^2, 16^2 and 32^2 (640 | 640) planes, its split form two on
the other 5; ``group_norm_cat_plan``) and its 12 in_convs two convs each
(K4 28 a b1 UNet call; the halves of the 16^2 and 32^2 in_convs read in
place by K4's sm90 body). Phase 1 holds both forms at every (Ca | Cb) pair
of UNet batches 1 to 4 (the replaced split form beside each slab
case; the materialized port path, torch.cat + K3, and torch.cat +
``F.group_norm`` + ``F.silu`` beside every case) and K4's narrow bodies
(``conv3x3_narrow``: Co <= 8 or C <= 16) at every shape the paths launch
them at (the replaced body, csrc/conv3x3.cu, beside each); phase 4 also
samples with the fusion off and on, in turns, prints both s/step and the
device time of the weight halves still copied a call; phase 17(a)
differentiates the two-output form.

``python3 chip_smoke.py --ranks 4`` runs only phase 20 (d), on four NCCL
ranks a card each: TP at model 4 and DP at data 4, with the same checks.
Phase 1's UNet groups come from ``kernel_cases.unet_call_groups``; a
full-width UNet call whose K1-K4 shapes none of them holds fails its
path's launch check (``check_held``).

Each path of phases 2, 4 to 12 and 14 to 22 runs with every launch count set to 0
just before it and read just after, and fails unless the kernels it must
run were launched (phase 12, render by render: K1's sm90 body 15 times, K2
its plans' kernels for 16 calls, K3 61 calls (12 of them two-source) and
K4's sm90 body 28 times a UNet call, K3 30 calls and K1's wide body once a decode, K3 22 calls and
K1's wide body once an encode, nothing on the f32 bodies, K5 or the
probes): in phases 2, 4, 6 and 7 every UNet self-attention site on K1's
sm90 body (phase 11: its fused 3xTF32 body), in phases 2, 4 and 6
every GEGLU FF call on K2's bf16 body with the kernels its plan predicts
(the library reports what it launched; phase 11: its f32 body, none on the
bf16 one), in phases 2 and 11 the f32 VAE mid-block on K1's 3xTF32 body
(its split, scores, softmax and output kernels), in phase 7's f32 cm sites
K1's fused 3xTF32 body and K5's f32 body once a site, in phases 4, 6, 8 and
9 every batch-1 UNet conv on K4's sm90 body (phase 11: its f32 body, none
on the bf16 one), in phases 2 to 8 and 11 every GroupNorm (61 a UNet call, 30 a decode, 22 an
encode) on K3's Hopper body with the kernels its plans predict (the library
reports what it launched) and none on its replaced body, and in phases 3 to
6 and 8 every bf16 VAE mid-block attention on K1's wgmma wide body (its
scores, softmax and output kernels). Phase 13 predicts each count from
the SD 2.1 config's sites and the kernels' plans (``unet_call_launches``):
K1's sm90 body 16 times a UNet call at 768x768 (the middle block's 144
tokens too), K4's sm90 body on the 14 convs of the 24^2 plane at batch 1 (11 and the
3 split in_convs)
and none at batch 4, the f32 mid-block's kernels by ``f32_sm90_launches``
and the bf16 one's by ``bf16_wide_launches`` at S = 9216. Phase 17's and
phase 18's forwards under grad launch what their UNet calls and decodes
predict, and their backwards launch nothing (the backward rules recompute
the plain twins).
Any failure exits non-zero before the result lines. On success the
last three lines are the kernels JSON (each kernel's ``backward`` rule
beside it), the card's name and power limit (from nvidia-smi) and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "complex_prompt_diffusion_tpu_torch"

# kernel -> (source, the TPU kernel(s) it replaces)
KERNELS = {
    "attention_bf16_wide_sm90": (
        f"{PKG}/csrc/attention_bf16_wide_sm90.cu",
        "complex_prompt_diffusion_tpu/ops/attention.py:48 _attn_kernel (bf16, 256 < d <= 512)",
    ),
    "attention_f32_sm90": (
        f"{PKG}/csrc/attention_f32_sm90.cu",
        "complex_prompt_diffusion_tpu/ops/attention.py:48 _attn_kernel (f32, 160 < d <= 512)",
    ),
    "attention_f32_fused_sm90": (
        f"{PKG}/csrc/attention_f32_fused_sm90.cu",
        "complex_prompt_diffusion_tpu/ops/attention.py:48 _attn_kernel; "
        "complex_prompt_diffusion_tpu/ops/attention.py:152 _onepass_kernel (f32, d <= 160)",
    ),
    "attention_sm90": (
        f"{PKG}/csrc/attention_sm90.cu",
        "complex_prompt_diffusion_tpu/ops/attention.py:152 _onepass_kernel; "
        "complex_prompt_diffusion_tpu/ops/attention.py:48 _attn_kernel (bf16, d <= 256)",
    ),
    "geglu_ff": (
        f"{PKG}/csrc/geglu_ff_sm90.cu",
        "complex_prompt_diffusion_tpu/ops/mlp.py:51 _ff_kernel (bf16)",
    ),
    "geglu_ff_f32_sm90": (
        f"{PKG}/csrc/geglu_ff_f32_sm90.cu",
        "complex_prompt_diffusion_tpu/ops/mlp.py:51 _ff_kernel (f32)",
    ),
    "group_norm": (
        f"{PKG}/csrc/groupnorm_sm90.cu",
        "complex_prompt_diffusion_tpu/ops/groupnorm.py:59 _gn_kernel; "
        "complex_prompt_diffusion_tpu/ops/groupnorm.py:142 _gn_stats_kernel; "
        "complex_prompt_diffusion_tpu/ops/groupnorm.py:175 _gn_stats2_kernel; "
        "complex_prompt_diffusion_tpu/ops/groupnorm.py:221 _gn_apply_kernel",
    ),
    "group_norm_cat": (
        f"{PKG}/csrc/groupnorm_sm90.cu",
        "complex_prompt_diffusion_tpu/ops/groupnorm.py:376 group_norm_silu_cat (XLA in the JAX "
        "package: the UNet's up-path GroupNorm+SiLU over a virtual skip concat; K3's two-source "
        "form on the card, its split form where no slab fits)",
    ),
    "group_norm_cat_slab": (
        f"{PKG}/csrc/groupnorm_sm90.cu",
        "complex_prompt_diffusion_tpu/ops/groupnorm.py:376 group_norm_silu_cat (K3's two-source "
        "slab form: one launch where the virtual row's groups of a sample fit a block)",
    ),
    "conv3x3": (
        f"{PKG}/csrc/conv3x3.cu",
        "complex_prompt_diffusion_tpu/ops/conv.py:38 _kernel (bf16 with C % 8 != 0, f32 with C % "
        "4 != 0; both with Co > 8 and C > 16)",
    ),
    "conv3x3_narrow": (
        f"{PKG}/csrc/conv3x3_narrow.cu",
        "complex_prompt_diffusion_tpu/ops/conv.py:38 _kernel (bf16 and f32 outside the Hopper "
        "bodies' widths with Co <= 8 or C <= 16)",
    ),
    "conv3x3_sm90": (
        f"{PKG}/csrc/conv3x3_sm90.cu",
        "complex_prompt_diffusion_tpu/ops/conv.py:38 _kernel (bf16, C % 8 == 0, any Co; Co > 8 "
        "and C > 16)",
    ),
    "conv3x3_f32_sm90": (
        f"{PKG}/csrc/conv3x3_f32_sm90.cu",
        "complex_prompt_diffusion_tpu/ops/conv.py:38 _kernel (f32, C % 4 == 0, any Co; Co > 8 "
        "and C > 16)",
    ),
    "attention_cm_sm90": (
        f"{PKG}/csrc/attention_cm_sm90.cu",
        "complex_prompt_diffusion_tpu/ops/attention.py:187 _onepass_kernel_hdbs; "
        "complex_prompt_diffusion_tpu/ops/attention.py:378 _onepass_kernel_kcanon (bf16)",
    ),
    "attention_cm_f32_sm90": (
        f"{PKG}/csrc/attention_cm_f32_sm90.cu",
        "complex_prompt_diffusion_tpu/ops/attention.py:187 _onepass_kernel_hdbs; "
        "complex_prompt_diffusion_tpu/ops/attention.py:378 _onepass_kernel_kcanon (f32)",
    ),
    "winograd": (
        f"{PKG}/csrc/winograd.cu",
        "complex_prompt_diffusion_tpu/ops/probes/winograd.py:82 _wino_kernel (bf16 with C % 8 != "
        "0, f32 with C % 4 != 0)",
    ),
    "winograd_sm90": (
        f"{PKG}/csrc/winograd_sm90.cu",
        "complex_prompt_diffusion_tpu/ops/probes/winograd.py:82 _wino_kernel (bf16, C % 8 == 0, "
        "any Co)",
    ),
    "winograd_f32_sm90": (
        f"{PKG}/csrc/winograd_f32_sm90.cu",
        "complex_prompt_diffusion_tpu/ops/probes/winograd.py:82 _wino_kernel (f32, C % 4 == 0, "
        "any Co)",
    ),
    "probe_attention": (
        f"{PKG}/csrc/probe_attention.cu",  # with the sources in PROBE_ATTENTION_SOURCES
        "scripts/perf_attn8.py:88 flash_t; scripts/perf_attn9.py:81 onepass; "
        "scripts/perf_attn10.py:84 run_mode; scripts/perf_attn11.py:92 h2; "
        "scripts/perf_attn12.py:51 v3_call, :105 h1_call (QK-only forms); "
        "scripts/perf_attn11.py:56 h1 is K5 (attention_cm_sm90)",
    ),
    "probe_groupnorm": (
        f"{PKG}/csrc/probe_groupnorm.cu",
        "scripts/perf_gn4.py:43,63 chunked, :96 flat_onepass; scripts/perf_gn5.py:111 make; "
        "scripts/perf_gn6.py:73 make",
    ),
    "probe_copy": (
        f"{PKG}/csrc/probe_copy_sm90.cu",
        "scripts/perf_gn7.py:36 make; scripts/perf_gn8.py:29 make",
    ),
}
# K7's sources: its entries, its instantiations of K1's Hopper loop (one
# file a head dim) and the loops it runs
PROBE_ATTENTION_SOURCES = tuple(f"{PKG}/csrc/{f}" for f in (
    "probe_attention.cu", "probe_attention_w40.cu", "probe_attention_w80.cu",
    "probe_attention_w160.cu", "probe_attention_sm90.cuh", "attention_sm90.cuh",
    "attention_cm_sm90.cuh", "attention_f32_fused.cuh"))
# the probes: no layer calls them; phase 10 runs the last three
PROBES = ("winograd", "winograd_sm90", "winograd_f32_sm90", "probe_attention", "probe_groupnorm",
          "probe_copy")
PHASE10_PROBES = PROBES[3:]
# K1's, K2's f32, K4's, K5's and K6's Hopper bodies, counted inside
# "attention", "geglu_ff", "conv3x3", "attention_cm" (K5's f32 body inside
# its Hopper count) and "winograd"; K3's two-source form inside "group_norm",
# its slab form inside "group_norm_cat"; K4's narrow bodies inside "conv3x3"
SM90 = {"group_norm_cat_slab": "group_norm_cat", "conv3x3_narrow": "conv3x3",
        "attention_sm90": "attention", "attention_f32_sm90": "attention",
        "attention_f32_fused_sm90": "attention",
        "attention_bf16_wide_sm90": "attention", "conv3x3_sm90": "conv3x3",
        "conv3x3_f32_sm90": "conv3x3", "geglu_ff_f32_sm90": "geglu_ff",
        "attention_cm_sm90": "attention_cm", "attention_cm_f32_sm90": "attention_cm_sm90",
        "winograd_sm90": "winograd", "winograd_f32_sm90": "winograd",
        "group_norm_cat": "group_norm"}
# phase 1's K1 f32, K5 and K6 cases (kernels "attention", "attention_cm" and
# "winograd", the routes) by the body they run
K1_BODY = {"float32": "attention_f32_fused_sm90"}
K5_BODY = {"bfloat16": "attention_cm_sm90", "float32": "attention_cm_f32_sm90"}
K6_BODY = {"bfloat16": "winograd_sm90", "float32": "winograd_f32_sm90"}
# the Hopper kernels phase 0 finds in the SASS: every instantiation must hold
# wgmma (HGMMA) and TMA loads (UTMALDG). attention_sm90_kernel is K1's and
# K7's (K1's loop in K7's modes), attention_cm_sm90_kernel K5's bf16 and
# K7's, attention_f32x3_kernel the fused 3xTF32 body of K1, K5 and K7;
# geglu_gemm_f32_sm90_kernel, conv3x3_f32_sm90_kernel and
# wino3x3_f32_sm90_kernel K2's, K4's and K6's f32 bodies, whose wgmma must be
# TF32 ones (TF32_FUNCTIONS)
SM90_FUNCTIONS = ("attention_sm90_kernel", "tf32x3_gemm_kernel", "wide_gemm_kernel",
                  "geglu_gemm_sm90_kernel", "conv3x3_sm90_kernel", "attention_cm_sm90_kernel",
                  "attention_f32x3_kernel", "wino3x3_sm90_kernel", "geglu_gemm_f32_sm90_kernel",
                  "conv3x3_f32_sm90_kernel", "wino3x3_f32_sm90_kernel")
TF32_FUNCTIONS = ("geglu_gemm_f32_sm90_kernel", "conv3x3_f32_sm90_kernel",
                  "wino3x3_f32_sm90_kernel")
# K7's loads-only mode of K1's loop (MODE 6 of attention_sm90_kernel<DV, BKV,
# MODE, ...>) computes nothing: TMA loads, no wgmma
LOADS_ONLY = re.compile(r"attention_sm90_kernelILi\d+ELi\d+ELi6E")
# K3's, K8's (K3's kernels in K8's modes) and K9's kernels: every
# instantiation must load by TMA (UTMALDG) or bulk copy (UBLKCP)
BULK_FUNCTIONS = ("gn_slab_kernel", "gn_stats_kernel", "gn_apply_kernel", "gn_cat_stats_kernel",
                  "gn_cat_apply_kernel", "gn_cat_slab_kernel", "copy_bulk_kernel")
# K8's instantiations with the tensor-core statistics (MMA = true: the slab
# kernel <bf16, full, true>, the statistics kernel <bf16, true>) must hold
# mma.sync (HMMA) or wgmma (HGMMA)
MMA_STATS = re.compile(r"gn_slab_kernelI13__nv_bfloat16Li0ELb1E|"
                       r"gn_stats_kernelI13__nv_bfloat16Lb1E")

TOL = {"bfloat16": 2e-2, "float32": 1e-4}  # max |a - b| / max |b|
# phase 1's names for the body beside a case, by the case's kernel
PRIOR_NAMES = {"group_norm_cat_slab": "replaced body (the split two-source form)",
               "conv3x3_narrow": "replaced body (csrc/conv3x3.cu)"}
# the kernels whose cases phase 1 runs twice, the two outputs held to the
# same bits (sums in a fixed order)
REPEAT_BITS = ("group_norm_cat", "group_norm_cat_slab", "conv3x3_narrow")

DDIM_PATH_KERNELS = ("attention", "geglu_ff", "group_norm", "conv3x3")  # phases 4 and 6
UNET_CONVS_PER_CALL_B1 = 22  # 3x3 convs on the 16^2/32^2 planes at UNet batch 2
UNET_CONVS_16_LATENT = 13  # of a UNet call on a 16x16 latent: conv_in, out conv and 11 more
UNET_FF_SITES = 16  # GEGLU FF calls a UNet call: 5 at each of three levels, 1 in the middle
K_STEPS = 20  # steps of the k-diffusion paths (phases 7 and 8)
UNET_SELF_ATTN_SITES = 15  # self-attention sites above S = 128 at 512x512: 5 a level
UNET_CM_SITES = 10  # of them inside the cm gate (levels 1 and 2: C = 640, 1280)
UNET_GN_CALLS = 61  # GroupNorms a UNet call (tools/kernel_cases.py: GN_B4_CALLS)
# of them, on K3's two-source form where the up path is fused (bf16, UNet
# batch <= 4): the 12 up-path ResBlocks' in_norms (kernel_cases.GN_CAT_CALLS)
UNET_CAT_CALLS = 12
VAE_DECODE_GN_CALLS = 30  # GroupNorms a VAE decode: mid-block 5, up levels 24, out 1
VAE_ENCODE_GN_CALLS = 22  # a VAE encode: down levels 16, mid-block 5, out 1


# v2-inference-v.yaml's ``model:`` section (SD 2.1 768-v), parsed: the card
# has no PyYAML, so phase 13 hands this to ``config.bundle_from_config``
# (tests/test_torch_checkpoint.py holds it to the YAML text)
V2_INFERENCE_V_MODEL = {
    "base_learning_rate": 0.0001,
    "target": "ldm.models.diffusion.ddpm.LatentDiffusion",
    "params": {
        "parameterization": "v", "linear_start": 0.00085, "linear_end": 0.012,
        "num_timesteps_cond": 1, "log_every_t": 200, "timesteps": 1000,
        "first_stage_key": "jpg", "cond_stage_key": "txt", "image_size": 96, "channels": 4,
        "cond_stage_trainable": False, "conditioning_key": "crossattn",
        "monitor": "val/loss_simple_ema", "scale_factor": 0.18215, "use_ema": False,
        "unet_config": {
            "target": "ldm.modules.diffusionmodules.openaimodel.UNetModel",
            "params": {
                "use_checkpoint": True, "use_fp16": True, "image_size": 32, "in_channels": 4,
                "out_channels": 4, "model_channels": 320, "attention_resolutions": [4, 2, 1],
                "num_res_blocks": 2, "channel_mult": [1, 2, 4, 4], "num_head_channels": 64,
                "use_spatial_transformer": True, "use_linear_in_transformer": True,
                "transformer_depth": 1, "context_dim": 1024, "legacy": False}},
        "first_stage_config": {
            "target": "ldm.models.autoencoder.AutoencoderKL",
            "params": {
                "embed_dim": 4, "monitor": "val/rec_loss",
                "ddconfig": {"double_z": True, "z_channels": 4, "resolution": 256,
                             "in_channels": 3, "out_ch": 3, "ch": 128, "ch_mult": [1, 2, 4, 4],
                             "num_res_blocks": 2, "attn_resolutions": [], "dropout": 0.0},
                "lossconfig": {"target": "torch.nn.Identity"}}},
        "cond_stage_config": {
            "target": "ldm.modules.encoders.modules.FrozenOpenCLIPEmbedder",
            "params": {"freeze": True, "layer": "penultimate"}},
    },
}


# v2-midas-inference.yaml's ``model:`` section (SD 2's depth model), parsed:
# phase 15 hands it to ``config.bundle_from_config`` (tests/test_torch_depth.py
# holds it to the YAML text and the bundle it gives to UNetConfig.sd2_depth)
V2_MIDAS_MODEL = {
    "base_learning_rate": 5.0e-07,
    "target": "ldm.models.diffusion.ddpm.LatentDepth2ImageDiffusion",
    "params": {
        "linear_start": 0.00085, "linear_end": 0.012, "num_timesteps_cond": 1,
        "log_every_t": 200, "timesteps": 1000, "first_stage_key": "jpg", "cond_stage_key": "txt",
        "image_size": 64, "channels": 4, "cond_stage_trainable": False,
        "conditioning_key": "hybrid", "scale_factor": 0.18215,
        "monitor": "val/loss_simple_ema", "finetune_keys": None, "use_ema": False,
        "depth_stage_config": {"target": "ldm.modules.midas.api.MiDaSInference",
                               "params": {"model_type": "dpt_hybrid"}},
        "unet_config": {
            "target": "ldm.modules.diffusionmodules.openaimodel.UNetModel",
            "params": {
                "use_checkpoint": True, "image_size": 32, "in_channels": 5, "out_channels": 4,
                "model_channels": 320, "attention_resolutions": [4, 2, 1], "num_res_blocks": 2,
                "channel_mult": [1, 2, 4, 4], "num_head_channels": 64,
                "use_spatial_transformer": True, "use_linear_in_transformer": True,
                "transformer_depth": 1, "context_dim": 1024, "legacy": False}},
        "first_stage_config": {
            "target": "ldm.models.autoencoder.AutoencoderKL",
            "params": {
                "embed_dim": 4, "monitor": "val/rec_loss",
                "ddconfig": {"double_z": True, "z_channels": 4, "resolution": 256,
                             "in_channels": 3, "out_ch": 3, "ch": 128, "ch_mult": [1, 2, 4, 4],
                             "num_res_blocks": 2, "attn_resolutions": [], "dropout": 0.0},
                "lossconfig": {"target": "torch.nn.Identity"}}},
        "cond_stage_config": {
            "target": "ldm.modules.encoders.modules.FrozenOpenCLIPEmbedder",
            "params": {"freeze": True, "layer": "penultimate"}},
    },
}


class SmokeFailure(Exception):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    if not out:
        raise SmokeFailure("nvidia-smi printed no card")
    return out[0].strip()


def rel_err(got, want) -> tuple:
    """(max |got - want|, that over max |want|); non-finite output, or
    output of another shape, fails. A pair of outputs (K3's two-source
    form's halves) counts as its concatenation along the channels."""
    import torch

    if isinstance(got, tuple):
        got = torch.cat(got, dim=-1)
    if isinstance(want, tuple):
        want = torch.cat(want, dim=-1)
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise SmokeFailure(f"output of shape {list(got.shape)}, want {list(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise SmokeFailure("kernel output has non-finite values")
    abs_err = float((got - want).abs().max())
    return abs_err, abs_err / max(float(want.abs().max()), 1e-30)


def phase0_sass(card: str) -> None:
    """The TMA + wgmma bodies of K1, K2, K4, K5, K6 and K7 as built: every
    instantiation must hold HGMMA (wgmma) and UTMALDG (TMA tensor load)
    instructions (K7's loads-only mode UTMALDG alone), K2's, K4's and K6's
    f32 bodies TF32 wgmma only; K3's, K8's and K9's kernels a TMA or
    bulk-copy load (UTMALDG or UBLKCP), K8's tensor-core statistics HMMA or
    HGMMA."""
    from complex_prompt_diffusion_tpu_torch.tools import probe_attention as PA

    counts = PA.sass_counts()
    for body in SM90_FUNCTIONS:
        fns = {n: c for n, c in counts.items() if body in n}
        bad = [n for n, c in fns.items()
               if (c["HGMMA"] == 0 and not LOADS_ONLY.search(n)) or c["UTMALDG"] == 0]
        hg = sorted(c["HGMMA"] for c in fns.values())
        tm = sorted(c["UTMALDG"] for c in fns.values())
        print(f"phase0: SASS (cuobjdump) of {body}: {len(fns)} instantiations, HGMMA "
              f"{hg[0] if hg else 0}..{hg[-1] if hg else 0}, UTMALDG {tm[0] if tm else 0}.."
              f"{tm[-1] if tm else 0} a function ({card})")
        if not fns or bad:
            raise SmokeFailure(f"{body}: no instantiation, or one without HGMMA or UTMALDG: "
                               f"{bad or 'none built'}")
        if body in TF32_FUNCTIONS:
            not_tf32 = [n for n, c in fns.items() if c["HGMMA.TF32"] != c["HGMMA"]]
            print(f"phase0: {body}: HGMMA on TF32 operands "
                  f"{sorted(c['HGMMA.TF32'] for c in fns.values())} a function ({card})")
            if not_tf32:
                raise SmokeFailure(f"{body}: wgmma other than TF32 in {not_tf32}")
    for body in BULK_FUNCTIONS:
        fns = {n: c["UTMALDG"] + c["UBLKCP"] for n, c in counts.items() if body in n}
        bad = [n for n, c in fns.items() if c == 0]
        print(f"phase0: SASS (cuobjdump) of {body}: {len(fns)} instantiations, UTMALDG + UBLKCP "
              f"{sorted(fns.values())} ({card})")
        if not fns or bad:
            raise SmokeFailure(f"{body}: no instantiation, or one without a TMA or bulk-copy "
                               f"load: {bad or 'none built'}")
    mma = {n: c["HMMA"] + c["HGMMA"] for n, c in counts.items() if MMA_STATS.search(n)}
    print(f"phase0: SASS (cuobjdump) of K8's tensor-core statistics: {len(mma)} instantiations, "
          f"HMMA + HGMMA {sorted(mma.values())} ({card})")
    if len(mma) < 2 or not all(mma.values()):
        raise SmokeFailure(f"K8's tensor-core statistics: want the slab and statistics kernels "
                           f"with HMMA or HGMMA, got {mma or 'none built'}")


def same_bits(a, b) -> bool:
    """Whether two outputs of a kernel (a tensor, or a tuple of them) are
    bit for bit the same."""
    import torch

    if isinstance(a, tuple):
        return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def phase1(dev, card: str) -> dict:
    """Each kernel against its plain twin at its paths' shapes."""
    import torch

    from complex_prompt_diffusion_tpu_torch import _build
    from complex_prompt_diffusion_tpu_torch.tools.hotcold import L2_BYTES, METHOD, graph_ms
    from collections import Counter

    from complex_prompt_diffusion_tpu_torch.tools.kernel_cases import (
        B1_UNET_CONV_COUNTS,
        B1_UNET_CONVS,
        GEGLU_B1_ROWS,
        GEGLU_B4_CALLS,
        GEGLU_ROWS,
        GN_B4_CALLS,
        GN_CAT_CALLS,
        GN_CAT_PLANES,
        GN_UNET_PLANES,
        HBM_BYTES_PER_S,
        PEAK_FLOPS,
        host_us,
        kernel_cases,
        ldm_vq4_config,
        unet_batch_shapes,
        unet_sites,
    )
    from complex_prompt_diffusion_tpu_torch.models import UNetConfig

    summary = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                      "library_ms": 0.0, "replaced_ms": None, "materialized_ms": None,
                      "by": {"bytes": 0.0, "operations": 0.0}}
               for name in KERNELS}
    conv_ms = {}  # K4's time by case label, printed beside K6's at the same shape
    conv_rows = {}  # the sm90 K4 cases: label -> (kernel, mma.sync body, library, bound) ms
    ff_rows = {}  # K2's cases: label -> (kernel, plain, bound) ms
    gn_rows = {}  # K3's cases: label -> (kernel, replaced body, library, bound) ms
    # K3's two-source cases: label -> (kernel, materialized port path, library,
    # bound, the replaced split form) ms
    cat_rows = {}
    print(f"phase1: kernel vs plain twin on {card} (times: {METHOD}, one input repeated, "
          f"L2 hot; bound = max(flops / peak, bytes / 3.35 TB/s); working set = those bytes, "
          f"'< L2' where it fits the 50 MB L2)")
    for case in kernel_cases(dev):
        got = case.run()
        want = case.plain()
        torch.cuda.synchronize()
        abs_err, rel = rel_err(got, want)
        # the replaced body computes the same function on the same inputs:
        # held to the same twin, so that its time is the same work's
        prior_rel = rel_err(case.prior(), want)[1] if case.prior is not None else None
        # a repeat of the kernel gives the same bits (fixed-order sums)
        same = same_bits(case.run(), got) if case.kernel in REPEAT_BITS else None
        del got, want
        prior_ms = graph_ms(case.prior) if case.prior is not None else None
        mat_ms = graph_ms(case.materialized) if case.materialized is not None else None
        ms = graph_ms(case.run)
        plain_ms = graph_ms(case.plain)
        lib_ms = graph_ms(case.library) if case.library is not None else None
        bound_ms, by = case.bound()
        # the 3xTF32 bodies (K1's, K2's, K4's, K5's and K6's f32 ones) are
        # held to 1e-5, as the card tests hold them: one TF32 product (~1e-3)
        # would miss it. K4's and K6's replaced FMA bodies keep the f32
        # tolerance they were held to as the kernel: K4's sequential f32 sums
        # over K = 9C (up to 23040) differ from the twin's by up to ~1e-5
        tol = 1e-5 if case.rate == "tf32x3" else TOL[case.dtype]
        prior_tol = (TOL[case.dtype] if case.kernel in ("conv3x3_f32_sm90", "winograd")
                     else tol)
        ok = rel <= tol and (prior_rel is None or prior_rel <= prior_tol) and same is not False
        lib_txt = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
        if case.kernel in ("conv3x3", "conv3x3_sm90", "conv3x3_f32_sm90"):
            conv_ms[case.label] = ms
        if case.kernel in ("conv3x3_sm90", "conv3x3_f32_sm90"):
            conv_rows[case.label] = (ms, prior_ms, lib_ms, bound_ms)
        elif case.kernel in ("geglu_ff", "geglu_ff_f32_sm90"):
            ff_rows[case.label] = (ms, plain_ms, bound_ms)
        elif case.kernel == "group_norm":
            gn_rows[case.label] = (ms, prior_ms, lib_ms, bound_ms)
        elif case.kernel in ("group_norm_cat", "group_norm_cat_slab"):
            cat_rows[case.label] = (ms, mat_ms, lib_ms, bound_ms,
                                    ms if prior_ms is None else prior_ms)
        elif case.kernel == "winograd":
            k4 = conv_ms.get(case.label)
            lib_txt += f" K4={k4:.4f} ms" if k4 is not None else " K4=no case at this shape"
        l2 = " < L2" if case.nbytes < L2_BYTES else ""
        prior_name = PRIOR_NAMES.get(case.kernel, "replaced body")
        prior_txt = (f" {prior_name}={prior_ms:.4f} ms (rel {prior_rel:.3e})"
                     if prior_ms is not None else "")
        if mat_ms is not None:
            prior_txt += f" materialized (torch.cat + K3)={mat_ms:.4f} ms"
        if same is not None:
            prior_txt += f" same bits on a repeat: {same}"
        if case.rate == "tf32x3":  # the FMA rate's bound beside the 3xTF32 one
            fma_ms = max(case.flops / PEAK_FLOPS["float32"], case.nbytes / HBM_BYTES_PER_S) * 1e3
            lib_txt += f" bound at the f32 FMA rate={fma_ms:.4f} ms"
        print(f"  {case.kernel:10s} {case.label:30s} max_abs_err={abs_err:.3e} rel={rel:.3e} "
              f"(tol {tol:.0e}) kernel={ms:.4f} ms{prior_txt} plain={plain_ms:.4f} ms "
              f"library={lib_txt} bound={bound_ms:.4f} ms ({by}; {100 * bound_ms / ms:.1f}% "
              f"of the kernel's time) working set {case.nbytes / 1e6:.1f} MB{l2} ({card}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SmokeFailure(f"{case.kernel} {case.label}: relative error {rel:.3e} (tol "
                               f"{tol}; replaced body {prior_rel}, tol {prior_tol}; same bits "
                               f"on a repeat: {same})")
        body = {"attention": K1_BODY, "attention_cm": K5_BODY, "winograd": K6_BODY}.get(
            case.kernel)
        sm = summary[body[case.dtype] if body else case.kernel]
        sm["max_abs_err"] = max(sm["max_abs_err"], abs_err)
        sm["ms"] += ms
        sm["plain_ms"] += plain_ms
        sm["bound_ms"] += bound_ms
        sm["by"][by] += bound_ms
        if lib_ms is None:
            sm["library_ms"] = None
        elif sm["library_ms"] is not None:
            sm["library_ms"] += lib_ms
        if prior_ms is not None:
            sm["replaced_ms"] = (sm["replaced_ms"] or 0.0) + prior_ms
        if mat_ms is not None:
            sm["materialized_ms"] = (sm["materialized_ms"] or 0.0) + mat_ms
        torch.cuda.empty_cache()
    for dt, ub, body, prior in (("bf16", 1, "sm90 K4", "mma.sync body"),
                                ("bf16", 2, "sm90 K4", "mma.sync body"),
                                ("f32", 2, "K4's 3xTF32 body", "FMA body it replaced"),
                                ("bf16", 3, "sm90 K4", "mma.sync body"),
                                ("bf16", 4, "sm90 K4", "mma.sync body")):
        # the 22 convs of one UNet call at UNet batch 1 (attention guidance's
        # unconditional call), 2 (a batch-1 step), 3 or 4 (a batch-1 step of a
        # 2- or 3-factor prompt), each shape times its count
        sums = [0.0] * 4
        for (hw, c, co), n in zip(B1_UNET_CONVS, B1_UNET_CONV_COUNTS):
            row = conv_rows.get(f"{dt} B{ub} {hw}x{hw} {c}->{co}")
            if row is None:
                break
            sums = [a + n * (b or 0.0) for a, b in zip(sums, row)]
        else:
            print(f"phase1: the {sum(B1_UNET_CONV_COUNTS)} {dt} convs of a UNet call at UNet "
                  f"batch {ub}: {body} {sums[0]:.4f} ms, {prior} {sums[1]:.4f} ms, cuDNN "
                  f"{sums[2]:.4f} ms, bound {sums[3]:.4f} ms ({100 * sums[3] / sums[0]:.1f}% of "
                  f"the kernel's time; {card})")
    sd15 = UNetConfig.sd15()
    for dt, step, rows in (("bf16", "b4", GEGLU_ROWS[:4]), ("f32", "b4", GEGLU_ROWS[:4]),
                           ("f32", "b1", GEGLU_B1_ROWS),
                           ("bf16", "b1 unconditional (UNet batch 1)",
                            unet_batch_shapes(sd15, 64, 1)["ff"]),
                           ("bf16", "b1", GEGLU_B1_ROWS),
                           ("bf16", "2-factor b1", unet_batch_shapes(sd15, 64, 3)["ff"]),
                           ("bf16", "3-factor b1", unet_batch_shapes(sd15, 64, 4)["ff"]),
                           ("bf16", "3-factor b4", unet_batch_shapes(sd15, 64, 16)["ff"]),
                           ("bf16", "b1 tensor-parallel rank (model 2: half the hidden width)",
                            unet_batch_shapes(sd15, 64, 2, model=2)["ff"])):
        # the 16 GEGLU FF calls of one CFG step (UNet batch 8 or 2; 3 for a
        # 2-factor prompt, 4 or 16 for a 3-factor one), by level
        sums = [0.0] * 3
        for (m, c, *h4), n in zip(rows, GEGLU_B4_CALLS):
            row = ff_rows.get(f"{dt} M{m} C{c} H4 {h4[0] if h4 else 4 * c}")
            if row is None:
                break
            sums = [a + n * b for a, b in zip(sums, row)]
        else:
            print(f"phase1: the {sum(GEGLU_B4_CALLS)} {dt} GEGLU FF calls of a {step} CFG step "
                  f"({'/'.join(map(str, GEGLU_B4_CALLS))} over "
                  f"{'/'.join(f'M{r[0]}' for r in rows)}): K2 {sums[0]:.4f} ms, plain twin "
                  f"{sums[1]:.4f} ms, bound {sums[2]:.4f} ms ({100 * sums[2] / sums[0]:.1f}% of "
                  f"K2's time; {card})")
    for ub, step in ((8, "b4"), (2, "b1"), (1, "b1 unconditional"), (3, "2-factor b1"),
                     (4, "3-factor b1"), (16, "3-factor b4")):
        # the 61 GroupNorms of one CFG step (UNet batch (1 + factors) x
        # batch), by shape
        sums = [0.0] * 4
        for (side, c), n in zip(GN_UNET_PLANES, GN_B4_CALLS):
            row = gn_rows.get(f"bf16 {ub}x{side}x{side}x{c} silu")
            if row is None:
                break
            sums = [a + n * (b or 0.0) for a, b in zip(sums, row)]
        else:
            print(f"phase1: the {sum(GN_B4_CALLS)} GroupNorms of a {step} CFG step (UNet batch "
                  f"{ub}): K3 {sums[0]:.4f} ms, replaced body {sums[1]:.4f} ms, F.group_norm + "
                  f"F.silu {sums[2]:.4f} ms, bound {sums[3]:.4f} ms ("
                  f"{100 * sums[3] / sums[0]:.1f}% of K3's time; {card})")
    fused_sites = unet_sites(sd15, 64, fused=True)
    for ub, step in ((2, "b1"), (4, "3-factor b1"), (1, "b1 unconditional"), (3, "2-factor b1")):
        # the same step with the up path fused: its 49 one-input GroupNorms
        # and 12 on the two-source form (their materialized port path beside
        # them: torch.cat, then K3), and its 28 convs inside K4's gate
        plain = Counter(fused_sites["gn_planes"])
        gn = [gn_rows.get(f"bf16 {ub}x{side}x{side}x{c} silu") for side, c in plain]
        cat = [cat_rows.get(f"bf16 {ub}x{side}x{side}x{a}|{b} silu")
               for side, a, b in GN_CAT_PLANES]
        if None in gn or None in cat:
            continue
        one = [sum(n * r[i] for n, r in zip(plain.values(), gn)) for i in (0, 3)]
        two = [sum(n * (r[i] or 0.0) for n, r in zip(GN_CAT_CALLS, cat)) for i in range(5)]
        print(f"phase1: the {sum(plain.values()) + sum(GN_CAT_CALLS)} GroupNorms of a {step} CFG "
              f"step (UNet batch {ub}) with the up path fused: K3 {one[0] + two[0]:.4f} ms (one "
              f"input {one[0]:.4f} ms for {sum(plain.values())}, two-source form {two[0]:.4f} ms "
              f"for {sum(GN_CAT_CALLS)}, its replaced body (the split form at every pair) "
              f"{two[4]:.4f} ms; those {sum(GN_CAT_CALLS)} materialized: torch.cat + K3 "
              f"{two[1]:.4f} ms, torch.cat + F.group_norm + F.silu {two[2]:.4f} ms), bound "
              f"{one[1] + two[3]:.4f} ms ({100 * (one[1] + two[3]) / (one[0] + two[0]):.1f}% of "
              f"K3's time; the {sum(GN_CAT_CALLS)} two-source calls' {two[3]:.4f} ms, "
              f"{100 * two[3] / two[0]:.1f}% of theirs; {card})")
        convs = Counter(c for c in fused_sites["conv"] if c[0] in (16, 32))
        rows = [conv_rows.get(f"bf16 B{ub} {hw}x{hw} {c}->{co}") for hw, c, co in convs]
        if None not in rows:
            k4 = [sum(n * (r[i] or 0.0) for n, r in zip(convs.values(), rows)) for i in range(4)]
            print(f"phase1: the {sum(convs.values())} bf16 convs of a UNet call at UNet batch "
                  f"{ub} with the up path fused (the 12 in_convs split in two; 6 of them on "
                  f"the 16^2 and 32^2 planes): sm90 K4 {k4[0]:.4f} ms, mma.sync body "
                  f"{k4[1]:.4f} ms, cuDNN {k4[2]:.4f} ms, bound {k4[3]:.4f} ms "
                  f"({100 * k4[3] / k4[0]:.1f}% of the kernel's time; {card})")
    ldm = ldm_vq4_config()
    for dt, ub, fused in (("bf16", 2, True), ("bf16", 4, True), ("f32", 1, False),
                          ("f32", 2, False)):
        # phase 22's UNet calls at CompVis LDM-VQ-4's widths: the convs K4's
        # gate admits (the 32^2 and 16^2 planes), each shape times its count
        convs = Counter(c for c in unet_sites(ldm, 64, fused=fused)["conv"] if c[0] in (16, 32))
        rows = [conv_rows.get(f"{dt} B{ub} {hw}x{hw} {c}->{co}") for hw, c, co in convs]
        if None in rows:
            continue
        k4 = [sum(n * (r[i] or 0.0) for n, r in zip(convs.values(), rows)) for i in range(4)]
        off = sum(n for (_, c, co), n in convs.items() if c % 64 or co % 64)
        print(f"phase1: the {sum(convs.values())} {dt} convs of an LDM-VQ-4 widths UNet call at "
              f"UNet batch {ub} (up path {'fused' if fused else 'materialized'}; {off} with C or "
              f"Co off the 64-channel tile): K4's Hopper body {k4[0]:.4f} ms, the PR-2 body "
              f"(csrc/conv3x3.cu) {k4[1]:.4f} ms, cuDNN {k4[2]:.4f} ms, bound {k4[3]:.4f} ms "
              f"({100 * k4[3] / k4[0]:.1f}% of the kernel's time; {card})")
    lib = _build.kernel_library()
    base = torch.empty(2 * 32 * 32 * 640, dtype=torch.bfloat16, device=dev)
    ns = ctypes.c_double()
    _build.check(lib.cpd_tmap_encode_bench(20000, ctypes.byref(ns), base.data_ptr()),
                 "tensor-map encode")
    print(f"phase1: host cost of one TMA tensor-map encode (cuTensorMapEncodeTiled, a 4-D bf16 "
          f"map): {ns.value / 1e3:.3f} us, mean of 20000; a launch encodes 2 (K4) or 3 (K1)")
    print(f"phase1: host cost of one wrapper call, eager, at shapes where the card's work is a "
          f"few us (so the loop runs at the host's pace): "
          f"{', '.join(f'{n} {us:.1f} us' for n, us in host_us(dev).items())} ({card})")
    return summary


def geglu_launches_per_step(batch: int, dtype: str = "bfloat16", latent: int = 64) -> int:
    """K2's launches in one CFG step of SD-1.5 at a ``latent`` x ``latent``
    latent (512x512: 64; UNet batch 2 x batch) in ``dtype``: 5 calls at each
    of the three levels with transformer blocks and 1 in the middle block,
    each with the launches of its plan."""
    from complex_prompt_diffusion_tpu_torch.models import UNetConfig

    return unet_call_launches(UNetConfig.sd15(), latent, 2 * batch, dtype)["k2"]


def check_geglu(launches: dict, batch: int, steps: int, what: str,
                dtype: str = "bfloat16") -> None:
    """Every GEGLU FF call of a path's ``steps`` CFG steps on K2's body for
    ``dtype``, with the kernels its plans predict; none on the other body."""
    want = geglu_launches_per_step(batch, dtype) * steps
    f32 = launches["geglu_ff_f32_sm90"]
    if launches["geglu_ff"] != want or f32 != (want if dtype == "float32" else 0):
        raise SmokeFailure(f"K2 launched {launches['geglu_ff']} kernels in {what}, {f32} on its "
                           f"f32 body: want {want} ({steps} steps of batch {batch}, by their "
                           f"plans), all on its {dtype} body")


def reset_launches() -> None:
    from complex_prompt_diffusion_tpu_torch import ops
    from complex_prompt_diffusion_tpu_torch.ops import groupnorm as G

    for w in ops.KERNEL_WRAPPERS.values():
        w.launches = 0
    G.group_norm_nhwc.calls = G.group_norm_nhwc.planned = G.group_norm_prior.launches = 0
    G.group_norm_silu_cat.calls = 0


def read_launches() -> dict:
    """Each wrapper's launches; and K3's calls (its two-source form's
    among them, and on their own), the kernels its plans predicted, and the
    launches of its replaced body (which no path may reach)."""
    from complex_prompt_diffusion_tpu_torch import ops
    from complex_prompt_diffusion_tpu_torch.ops import groupnorm as G

    out = {name: w.launches for name, w in ops.KERNEL_WRAPPERS.items()}
    out["group_norm calls"] = G.group_norm_nhwc.calls
    out["group_norm planned"] = G.group_norm_nhwc.planned
    out["group_norm_prior"] = G.group_norm_prior.launches
    out["group_norm_cat calls"] = G.group_norm_silu_cat.calls
    return out


def check_gn(launches: dict, unet_calls: int, decodes: int, encodes: int, what: str,
             cat=(0, 0, 0)) -> None:
    """Every GroupNorm of a path on K3's Hopper body: as many calls as its
    UNet calls, VAE decodes and encodes have, ``cat`` (:func:`cat_counts`)
    of them on the two-source form (12 a fused UNet call) and the rest on
    one input, the kernels the library reported equal to what the calls'
    plans predict, none on the replaced body."""
    check_cat(launches, cat, what)
    want = (UNET_GN_CALLS * unet_calls + VAE_DECODE_GN_CALLS * decodes
            + VAE_ENCODE_GN_CALLS * encodes)
    if (launches["group_norm calls"] != want or launches["group_norm"] <= 0
            or launches["group_norm"] != launches["group_norm planned"]
            or launches["group_norm_prior"]):
        raise SmokeFailure(f"K3 in {what}: {launches['group_norm calls']} calls (want {want}: "
                           f"{unet_calls} UNet calls, {decodes} decodes, {encodes} encodes), "
                           f"{launches['group_norm']} kernels launched against "
                           f"{launches['group_norm planned']} planned, the replaced body "
                           f"{launches['group_norm_prior']}")


def cat_counts(per: dict, calls: int = 1) -> tuple:
    """(calls, kernels, slab kernels) of K3's two-source form in ``calls``
    UNet calls of ``per`` (:func:`unet_call_launches`)."""
    return tuple(calls * per[k] for k in ("k3_cat", "k3_cat_launches", "k3_cat_slab"))


def check_cat(launches: dict, cat, what: str) -> None:
    """K3's two-source form in a path: ``cat`` = (calls, kernels, slab
    kernels) as the calls' plans predict (:func:`cat_counts`: one launch a
    slab call, two a split one), and no other."""
    calls, kernels, slab = cat
    got = (launches["group_norm_cat calls"], launches["group_norm_cat"],
           launches["group_norm_cat_slab"])
    if got != (calls, kernels, slab):
        raise SmokeFailure(f"K3's two-source form in {what}: (calls, kernels, slab kernels) "
                           f"{got}: want {(calls, kernels, slab)} (the fused up path's, by "
                           f"group_norm_cat_plan)")


def check_wide(launches: dict, calls: int, batch: int, what: str, s: int = 4096,
               more=()) -> None:
    """Every bf16 VAE mid-block attention of a path (``calls`` of them, at
    ``batch`` and S = ``s``, and ``more`` (calls, batch) pairs) on K1's
    wgmma wide body, with the kernels its passes need; no other K1 launch
    outside the Hopper bodies."""
    from complex_prompt_diffusion_tpu_torch.ops.attention import bf16_wide_launches

    want = sum(n * bf16_wide_launches(b, 1, s, s) for n, b in ((calls, batch), *more))
    own = (launches["attention"] - launches["attention_sm90"] - launches["attention_f32_sm90"]
           - launches["attention_f32_fused_sm90"])
    if launches["attention_bf16_wide_sm90"] != want or own != want:
        raise SmokeFailure(f"K1 in {what}: the bf16 wide body launched "
                           f"{launches['attention_bf16_wide_sm90']} kernels and K1 {own} outside "
                           f"its sm90 and 3xTF32 bodies; want {want} on the wide body ({calls} "
                           f"bf16 d=512 mid-blocks at batch {batch})")


def check_k5_bf16(launches: dict, want: int, what: str) -> None:
    """``want`` K5 launches in a path, every one on its bf16 Hopper body."""
    if (launches["attention_cm"] != want or launches["attention_cm_sm90"] != want
            or launches["attention_cm_f32_sm90"]):
        raise SmokeFailure(f"K5 launched {launches['attention_cm']} kernels in {what}, "
                           f"{launches['attention_cm_sm90']} on its Hopper bodies, "
                           f"{launches['attention_cm_f32_sm90']} on the f32 one: want {want}, "
                           f"all on the bf16 body")


def check_image(images, shape) -> None:
    if images.dtype.name != "uint8" or images.shape != shape:
        raise SmokeFailure(f"images {images.dtype} {images.shape}, want uint8 {shape}")
    if int(images.max()) == int(images.min()):
        raise SmokeFailure("decoded images are constant")


def check_latents(latents, shape) -> None:
    import torch

    if tuple(latents.shape) != shape or not bool(torch.isfinite(latents).all()):
        raise SmokeFailure(f"latents are not finite {list(shape)}")


def phase2(dev, card: str, steps: int):
    """The main path at full SD-1.5 width; returns (bundle, launch counts,
    latents, images)."""
    import torch

    from complex_prompt_diffusion_tpu_torch.ops.attention import f32_sm90_launches
    from complex_prompt_diffusion_tpu_torch.pipeline import (
        ModelBundle,
        RenderConfig,
        decode_latents,
        txt2img,
    )

    t0 = time.perf_counter()
    bundle = ModelBundle.random("sd15", seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"phase2: SD-1.5 random bundle (UNet bf16, VAE f32) built in "
          f"{time.perf_counter() - t0:.2f} s")
    cfg = RenderConfig(steps=steps, sampler="DDIM", eta=0.0, guidance_scale=7.5,
                       width=512, height=512, batch_size=4, seed=0)

    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, latents = txt2img(bundle, "a photograph of an astronaut riding a horse",
                         cfg=cfg, decode=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    images = decode_latents(bundle, latents)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_launches()

    check_image(images, (4, 512, 512, 3))
    check_latents(latents, (4, 64, 64, 4))
    for name in ("attention", "geglu_ff", "group_norm"):
        if launches[name] <= 0:
            raise SmokeFailure(f"kernel {name} was not launched on the main path")
    if launches["conv3x3"] != 0:  # UNet batch 8 is outside the conv gate
        raise SmokeFailure(f"conv3x3 launched {launches['conv3x3']} times on the main path")
    # every UNet self-attention site on K1's sm90 body; the f32 VAE mid-block
    # (d = 512) on the 3xTF32 body, whose call launches the kernels its
    # passes need
    want_f32 = f32_sm90_launches(4, 1, 4096, 4096)
    if (launches["attention_sm90"] != UNET_SELF_ATTN_SITES * steps
            or launches["attention_f32_sm90"] != want_f32
            or launches["attention"] - launches["attention_sm90"] != want_f32):
        raise SmokeFailure(f"K1 launched {launches['attention']} times, the sm90 body "
                           f"{launches['attention_sm90']}, the 3xTF32 body "
                           f"{launches['attention_f32_sm90']}: want {UNET_SELF_ATTN_SITES} x "
                           f"{steps} on the sm90 body and the f32 d=512 decode on the 3xTF32 "
                           f"body ({want_f32} kernels)")
    check_geglu(launches, 4, steps, "the main path")
    check_gn(launches, steps, 1, 0, "the main path")
    check_wide(launches, 0, 4, "the main path")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"phase2: txt2img 512x512 b4 DDIM {steps} steps CFG 7.5 on {card}: "
          f"sampling {t1 - t0:.3f} s = {(t1 - t0) / steps:.4f} s/step (incl. prompt "
          f"encode and first-call warm-up), decode {1000 * (t2 - t1) / 4:.2f} ms/img, "
          f"end to end {4 / (t2 - t0):.4f} img/s, peak memory {peak_gb:.2f} GiB")
    print(f"phase2: launches {json.dumps(launches)}; latents mean "
          f"{float(latents.mean()):.5f} std {float(latents.std()):.5f}; "
          f"image mean {float(images.mean()):.2f}")
    return bundle, launches, latents, images


def phase3(bundle, dev, card: str) -> None:
    """Kernel path vs plain path on small inputs at full width."""
    import torch

    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch.pipeline import _tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = torch.device("cpu")
    gen = torch.Generator(device=cpu).manual_seed(7)

    def to_cpu(params):
        return _tree_map(lambda a: a.to(cpu), params)

    def compare(what, got, want, tol):
        rel = float((got.float() - want.float()).norm() / want.float().norm())
        print(f"phase3: {what}, CUDA kernels vs CPU plain twins: rel L2 err {rel:.3e} "
              f"(tol {tol:.0e}) ({card})")
        if not (rel <= tol):
            raise SmokeFailure(f"{what}: kernel path disagrees with the plain path: {rel:.3e}")

    # UNet: 16x16 latent (S = 256 self-attention reaches K1), uncond+cond;
    # level 0 runs on the 16^2 plane, inside the conv gate: its 16 3x3 convs
    # (13, the 3 up-path in_convs split in two by the fused skip concat),
    # conv_in (C = 4) and the out conv (Co = 4) among them, go through K4;
    # its 12 up-path GroupNorms through K3's two-source form, on both sides
    x = torch.randn((2, 16, 16, 4), generator=gen)
    t = torch.tensor([801, 801])
    ctx = torch.randn((2, 77, 768), generator=gen)
    per = unet_call_launches(bundle.unet_cfg, 16, 2)
    reset_launches()
    with torch.inference_mode():
        got = M.unet_apply(bundle.unet_cfg, bundle.unet_params, x.to(dev), t.to(dev),
                           ctx.to(dev)).cpu()
        n = read_launches()
        want = M.unet_apply(bundle.unet_cfg, to_cpu(bundle.unet_params), x, t, ctx)
    if (n["conv3x3"] != per["k4"] or n["conv3x3_sm90"] != per["k4_sm90"]
            or per["k4"] != UNET_CONVS_16_LATENT + 3 or per["k4_sm90"] != per["k4"] - 2
            or n["conv3x3_narrow"] != per["k4_narrow"] or per["k4_narrow"] != 2):
        raise SmokeFailure(f"the 16x16 UNet eval launched K4 {n['conv3x3']} times, "
                           f"{n['conv3x3_sm90']} on the sm90 body, {n['conv3x3_narrow']} on "
                           f"the narrow ones: want {per['k4']} (13 and the 3 split in_convs), "
                           f"all but conv_in (C = 4) and the out conv (Co = 4) on the sm90 "
                           f"body, those two on the narrow bodies")
    check_gn(n, 1, 0, 0, "the 16x16 UNet eval", cat_counts(per))
    compare(f"UNet eps 16x16 latent b2, bf16 weights, {per['k4']} convs through K4, "
            f"{UNET_CAT_CALLS} GroupNorms on K3's two-source form", got, want, 5e-2)
    # VAE decode in f32: 16x16 latent -> 128x128 image (mid attention S = 256;
    # the convs on the 16^2 and 32^2 planes through K4's f32 path)
    z = torch.randn((1, 16, 16, 4), generator=gen)
    reset_launches()
    with torch.inference_mode():
        got = M.vae_decode(bundle.vae_cfg, bundle.vae_params, z.to(dev)).cpu()
        n_conv = read_launches()["conv3x3"]
        want = M.vae_decode(bundle.vae_cfg, to_cpu(bundle.vae_params), z)
    if n_conv <= 0:
        raise SmokeFailure("the small f32 VAE decode launched no K4 conv")
    compare(f"VAE decode 16x16 latent f32 (TF32 off), {n_conv} convs through K4", got, want,
            1e-4)
    # the bf16 VAE: decode the same latent and encode a 128x128 image (mid
    # attention bf16 at S = 256, d = 512; the 16^2 and 32^2 planes through K4)
    vae16 = bundle.cast_vae("bfloat16")
    cpu16 = to_cpu(vae16.vae_params)
    img = torch.rand((1, 128, 128, 3), generator=gen) * 2 - 1
    reset_launches()
    with torch.inference_mode():
        got = M.vae_decode(vae16.vae_cfg, vae16.vae_params, z.to(dev)).cpu()
        got_enc = M.vae_encode(vae16.vae_cfg, vae16.vae_params, img.to(dev))
        launches = read_launches()
        want = M.vae_decode(vae16.vae_cfg, cpu16, z)
        want_enc = M.vae_encode(vae16.vae_cfg, cpu16, img)
    if launches["conv3x3"] <= 0:
        raise SmokeFailure(f"the small bf16 VAE decode and encode launched {launches}")
    check_wide(launches, 2, 1, "the small bf16 VAE decode and encode", s=256)
    check_gn(launches, 0, 1, 1, "the small bf16 VAE decode and encode")
    compare("VAE decode 16x16 latent bf16", got, want, 5e-2)
    compare("VAE encode 128x128 image bf16 (posterior mean)", got_enc.mean.cpu(),
            want_enc.mean, 5e-2)


def phase4(bundle, dev, card: str, steps: int) -> dict:
    """The batch-1 render with a bf16 VAE decode (the JAX package's latency
    row); returns its launch counts."""
    import torch

    from complex_prompt_diffusion_tpu_torch.pipeline import RenderConfig, decode_latents, txt2img

    cfg = RenderConfig(steps=steps, sampler="DDIM", eta=0.0, guidance_scale=7.5,
                       width=512, height=512, batch_size=1, seed=1)
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, latents = txt2img(bundle, "a watercolor painting of a lighthouse at dusk", cfg=cfg,
                         decode=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    before = read_launches()
    images = decode_latents(bundle, latents)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_launches()
    decode_latents(bundle, latents)
    torch.cuda.synchronize()
    t3 = time.perf_counter()

    check_image(images, (1, 512, 512, 3))
    check_latents(latents, (1, 64, 64, 4))
    for name in DDIM_PATH_KERNELS + ("group_norm_cat", "group_norm_cat_slab"):
        if launches[name] <= 0:
            raise SmokeFailure(f"kernel {name} was not launched in the batch-1 render")
    per = unet_call_launches(bundle.unet_cfg, 64, 2)
    want = per["k4_sm90"] * steps
    if (launches["conv3x3"] != want or launches["conv3x3_sm90"] != want
            or per["k4"] != UNET_CONVS_PER_CALL_B1 + 6 or per["k3_cat"] != UNET_CAT_CALLS):
        raise SmokeFailure(f"conv3x3 launched {launches['conv3x3']} times, the sm90 body "
                           f"{launches['conv3x3_sm90']}: want {want} ({per['k4']} a step: "
                           f"{UNET_CONVS_PER_CALL_B1} and the 6 split in_convs of the 16^2 and "
                           f"32^2 planes), all on the sm90 body")
    if launches["attention_sm90"] != UNET_SELF_ATTN_SITES * steps:
        raise SmokeFailure(f"K1's sm90 body launched {launches['attention_sm90']} times, want "
                           f"{UNET_SELF_ATTN_SITES} x {steps}")
    check_geglu(launches, 1, steps, "the batch-1 render")
    check_gn(launches, steps, 1, 0, "the batch-1 render", cat_counts(per, steps))
    check_wide(launches, 1, 1, "the batch-1 render")
    decode_attn = launches["attention"] - before["attention"]
    if bundle.vae_cfg.dtype != "bfloat16" or decode_attn != launches["attention_bf16_wide_sm90"]:
        raise SmokeFailure(f"the bf16 decode launched K1 {decode_attn} times (VAE "
                           f"{bundle.vae_cfg.dtype}), want the one bf16 d=512 mid-block")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"phase4: batch-1 txt2img 512x512 DDIM {steps} steps CFG 7.5, bf16 VAE decode, on "
          f"{card}: seconds to first image {t2 - t0:.3f} s end to end (incl. prompt encode "
          f"and first-call warm-up), {(t1 - t0) / steps:.4f} s/step, decode "
          f"{1000 * (t2 - t1):.2f} ms (first call), {1000 * (t3 - t2):.2f} ms (second), "
          f"peak memory {peak_gb:.2f} GiB")
    print(f"phase4: launches {json.dumps(launches)} (conv3x3 = {per['k4']} x {steps} steps; "
          f"group_norm_cat = {per['k3_cat_launches']} kernels ({per['k3_cat_slab']} slab, "
          f"{UNET_CAT_CALLS} calls) x {steps}; attention in the decode: "
          f"{decode_attn} kernels, bf16 d=512)")
    phase4_fused_ab(bundle, cfg, card, steps, latents)
    return launches


def split_once():
    """A stand-in for ``models.unet._split_weight`` that copies each
    weight's two halves once, in the weight's memory format, and keeps them
    (with the weight) while the stand-in lives: the form phase 4 times
    against the per-call views K4 and cuDNN copy at every call."""
    import torch

    kept = {}

    def split(p, ca):
        w = p["weight"]
        hit = kept.get((id(w), ca))
        if hit is None:
            fmt = (torch.channels_last if w.is_contiguous(memory_format=torch.channels_last)
                   else torch.contiguous_format)
            hit = kept[(id(w), ca)] = (w, w[:, :ca].contiguous(memory_format=fmt),
                                       w[:, ca:].contiguous(memory_format=fmt),
                                       torch.zeros_like(p["bias"]))
        return hit[1:]

    return split


def phase4_fused_ab(bundle, cfg, card: str, steps: int, latents) -> None:
    """The batch-1 render's sampling with the up path's skip concat fused
    (the default, K3's two-source form and the split convs over per-call
    weight views), fused with the split weights copied once and kept
    (:func:`split_once`), and materialized (``models.unet._FUSE_SKIP_CAT``
    off: torch.cat, then K3 on the concat and one conv), in turns (off, on,
    once, once, on, off): s/step and peak memory of each, their launches as
    the UNet calls of each form predict, the forms' latents against each
    other, and the device time of the per-call copies of the weight halves
    (CUDA events)."""
    import torch

    from complex_prompt_diffusion_tpu_torch.models import unet as U
    from complex_prompt_diffusion_tpu_torch.models.layers import conv3x3_wanted
    from complex_prompt_diffusion_tpu_torch.ops.conv import k4_body
    from complex_prompt_diffusion_tpu_torch.pipeline import txt2img

    per_call = U._split_weight
    conv_split = U._conv_split
    # (id, Ca) -> (weight, Ca, (a's half read in place, b's)): the split convs
    # of the b1 UNet call; a half is read in place where its conv runs on a
    # Hopper body of K4 (whose TMA map walks the slice), and copied by
    # cuDNN (the 8^2 and 64^2 in_convs, the 1x1 skip convs) otherwise
    halves = {}
    operands = []  # the split conv's (a, b) while its halves are cut

    def in_place(w, t):
        return (w.shape[-1] == 3 and conv3x3_wanted(t, (w.shape[0], t.shape[-1], 3, 3))
                and k4_body(t.dtype, t.shape[-1], w.shape[0]) in ("bf16_sm90", "f32_sm90"))

    def recorded(p, ca):
        w = p["weight"]
        halves.setdefault((id(w), ca), (w, ca, tuple(in_place(w, t) for t in operands[-1])))
        return per_call(p, ca)

    def split_conv(p, a, b, shard=None):
        operands.append((a, b))
        try:
            return conv_split(p, a, b, shard)
        finally:
            operands.pop()

    secs = {"off": [], "on": [], "once": []}
    peak = {"off": [], "on": [], "once": []}
    out = {}
    U._conv_split = split_conv
    try:
        for form in ("off", "on", "once", "once", "on", "off"):
            U._FUSE_SKIP_CAT = form != "off"
            if form == "once":
                if U._split_weight in (recorded, per_call):  # the second turn keeps them
                    U._split_weight = split_once()
            else:  # the kept copies go before a turn that does not use them
                U._split_weight = recorded if not halves else per_call
            reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            _, lat = txt2img(bundle, "a watercolor painting of a lighthouse at dusk", cfg=cfg,
                             decode=False)
            torch.cuda.synchronize()
            secs[form].append((time.perf_counter() - t0) / steps)
            peak[form].append(torch.cuda.max_memory_allocated() / 2**30)
            name = "materialized" if form == "off" else "fused"
            check_unet_path(read_launches(), bundle.unet_cfg, 2, steps, 0, 0,
                            f"the batch-1 sampling with the up path {name} ({form})")
            out[form] = lat
    finally:
        U._FUSE_SKIP_CAT = True
        U._split_weight = per_call
        U._conv_split = conv_split
    check_latents(out["off"], (1, 64, 64, 4))
    rel = rel_err(out["on"], out["off"])[1]
    same = torch.equal(out["on"], latents)
    same_once = torch.equal(out["once"], out["on"])

    def cut(w, ca):
        return w[:, :ca], w[:, ca:]

    def copy_halves(every):
        for w, ca, kept in halves.values():
            for half, k in zip(cut(w, ca), kept):
                if every or not k:
                    half.contiguous()

    def nbytes(every):
        return sum(h.numel() * h.element_size() for w, ca, kept in halves.values()
                   for h, k in zip(cut(w, ca), kept) if every or not k)

    copied = sum(1 for *_, kept in halves.values() for k in kept if not k)
    copy_ms = event_ms(lambda: copy_halves(False), 10)
    all_ms = event_ms(lambda: copy_halves(True), 10)
    copy_gb, all_gb = 2 * nbytes(False) / 1e9, 2 * nbytes(True) / 1e9

    def two(form, vals, f):
        return " / ".join(f.format(v) for v in vals[form])

    print(f"phase4: b1 DDIM {steps} sampling on {card}, in turns off/on/once/once/on/off: up "
          f"path fused (K3 two-source + split convs over per-call weight views) "
          f"{two('on', secs, '{:.4f}')} s/step, peak {two('on', peak, '{:.3f}')} GiB; fused "
          f"with the split weights copied once and kept {two('once', secs, '{:.4f}')} s/step, "
          f"peak {two('once', peak, '{:.3f}')} GiB; materialized (torch.cat + K3 + one conv) "
          f"{two('off', secs, '{:.4f}')} s/step, peak {two('off', peak, '{:.3f}')} GiB (incl. "
          f"prompt encode); latents fused vs materialized max rel {rel:.3e} (bf16 arithmetic "
          f"in another order; printed, not held); the fused latents equal the first render's "
          f"bit for bit: {same}, the copied-once form's: {same_once}; the per-call copies "
          f"that remain, {copied} of the {2 * len(halves)} weight halves of a UNet call (the "
          f"others read in place by K4's Hopper bodies): {copy_ms:.4f} ms (CUDA events, "
          f"{copy_gb:.3f} GB read and written, bound {copy_gb / 3.35:.4f} ms at 3.35 TB/s); "
          f"all {2 * len(halves)} copied, as before: {all_ms:.4f} ms ({all_gb:.3f} GB, bound "
          f"{all_gb / 3.35:.4f} ms)", flush=True)


def phase5(bundle, latents, images_f32, card: str) -> dict:
    """Phase 2's latents through the bf16 VAE decode at batch 4, held to
    their f32 decode; returns its launch counts."""
    import numpy as np
    import torch

    from complex_prompt_diffusion_tpu_torch.pipeline import decode_latents

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images = decode_latents(bundle, latents)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = read_launches()
    decode_latents(bundle, latents)
    torch.cuda.synchronize()
    t2 = time.perf_counter()

    check_image(images, (4, 512, 512, 3))
    check_wide(launches, 1, 4, "the b4 bf16 decode")
    check_gn(launches, 0, 1, 0, "the b4 bf16 decode")
    diff = images.astype(np.float64) - images_f32.astype(np.float64)
    max_u8 = int(np.abs(diff).max())
    rel = float(np.linalg.norm(diff) / np.linalg.norm(images_f32.astype(np.float64)))
    print(f"phase5: bf16 VAE decode b4 512x512 on {card}: {1000 * (t1 - t0) / 4:.2f} ms/img "
          f"(first call), {1000 * (t2 - t1) / 4:.2f} ms/img (second); against the f32 "
          f"decode of the same latents: max |u8| diff {max_u8}, rel L2 {rel:.3e} (tol 5e-2)")
    print(f"phase5: launches {json.dumps(launches)}")
    if not rel <= 5e-2:
        raise SmokeFailure(f"bf16 decode differs from the f32 decode: rel L2 {rel:.3e}")
    return launches


def phase6(bundle, image, card: str, steps: int) -> dict:
    """img2img (DDIM, strength 0.75) of one phase-2 image at batch 1;
    returns its launch counts."""
    import torch

    from complex_prompt_diffusion_tpu_torch.pipeline import RenderConfig, img2img, img2img_t_enc

    cfg = RenderConfig(steps=steps, sampler="DDIM", eta=0.0, guidance_scale=7.5, width=512,
                       height=512, batch_size=1, seed=2, denoising_strength=0.75)
    t_enc = img2img_t_enc(cfg.denoising_strength, steps, "t")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images, latents = img2img(bundle, image, "an oil painting of an astronaut", cfg=cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = read_launches()

    check_image(images, (1, 512, 512, 3))
    check_latents(latents, (1, 64, 64, 4))
    for name in DDIM_PATH_KERNELS:
        if launches[name] <= 0:
            raise SmokeFailure(f"kernel {name} was not launched in img2img")
    per = unet_call_launches(bundle.unet_cfg, 64, 2)
    want = per["k4_sm90"] * t_enc
    if launches["conv3x3"] != want or launches["conv3x3_sm90"] != want:
        raise SmokeFailure(f"img2img ran conv3x3 {launches['conv3x3']} times, the sm90 body "
                           f"{launches['conv3x3_sm90']}: want {per['k4_sm90']} x "
                           f"{t_enc} steps, all on the sm90 body")
    if launches["attention_sm90"] != UNET_SELF_ATTN_SITES * t_enc:
        raise SmokeFailure(f"K1's sm90 body launched {launches['attention_sm90']} times in "
                           f"img2img, want {UNET_SELF_ATTN_SITES} x {t_enc}")
    check_geglu(launches, 1, t_enc, "img2img")
    check_gn(launches, t_enc, 1, 1, "img2img", cat_counts(per, t_enc))
    check_wide(launches, 2, 1, "img2img")
    print(f"phase6: img2img 512x512 b1 strength 0.75 DDIM {steps} ({t_enc} steps run) CFG "
          f"7.5, bf16 VAE encode and decode, on {card}: {t1 - t0:.3f} s end to end; "
          f"launches {json.dumps(launches)}; image mean {float(images.mean()):.2f}")
    return launches


def phase7(bundle, dev, card: str, steps: int) -> tuple:
    """The k-diffusion render at full width with the UNet's channel-major
    attention route on, then one UNet eval with that route against the same
    eval without it, then the cm sites in bf16 and f32; returns the render's
    launch counts and the sites' (both dtypes together)."""
    import dataclasses

    import torch

    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch.pipeline import RenderConfig, decode_latents, txt2img

    cm = dataclasses.replace(
        bundle, unet_cfg=dataclasses.replace(bundle.unet_cfg, attn_route="cm"))
    cfg = RenderConfig(steps=steps, sampler="DPM++ 2m", sigma_schedule="karras",
                       guidance_scale=7.5, width=512, height=512, batch_size=4, seed=3)
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, latents = txt2img(cm, "a castle on a cliff above the sea, oil on canvas", cfg=cfg,
                         decode=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    images = decode_latents(cm, latents)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_launches()

    check_image(images, (4, 512, 512, 3))
    check_latents(latents, (4, 64, 64, 4))
    check_k5_bf16(launches, UNET_CM_SITES * steps, "the k-diffusion render")
    if launches["attention_sm90"] != (UNET_SELF_ATTN_SITES - UNET_CM_SITES) * steps:
        raise SmokeFailure(f"K1's sm90 body launched {launches['attention_sm90']} times, want "
                           f"the level-0 sites of {steps} steps")
    if launches["geglu_ff"] <= 0:
        raise SmokeFailure("kernel geglu_ff was not launched in the k-diffusion render")
    check_gn(launches, steps, 1, 0, "the k-diffusion render")
    check_wide(launches, 0, 4, "the k-diffusion render")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"phase7: txt2img 512x512 b4 DPM++ 2M Karras {steps} steps CFG 7.5, cm attention "
          f"route, on {card}: sampling {t1 - t0:.3f} s = {(t1 - t0) / steps:.4f} s/step "
          f"(incl. prompt encode), f32 decode {1000 * (t2 - t1) / 4:.2f} ms/img, end to end "
          f"{4 / (t2 - t0):.4f} img/s, peak memory {peak_gb:.2f} GiB")
    print(f"phase7: launches {json.dumps(launches)}; latents mean "
          f"{float(latents.mean()):.5f} std {float(latents.std()):.5f}; "
          f"image mean {float(images.mean()):.2f}")

    # one UNet eval at the render's plane (UNet batch 2): cm route vs default
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((2, 64, 64, 4), generator=gen, device=dev)
    t = torch.tensor([601.5, 601.5], device=dev)  # a fractional timestep, as the denoiser gives
    ctx = torch.randn((2, 77, 768), generator=gen, device=dev)
    reset_launches()
    with torch.inference_mode():
        got = M.unet_apply(cm.unet_cfg, cm.unet_params, x, t, ctx)
        n_cm = read_launches()
        want = M.unet_apply(bundle.unet_cfg, bundle.unet_params, x, t, ctx)
    n_all = read_launches()
    n_k1 = n_all["attention"] - n_cm["attention"]
    if (n_cm["attention_cm"] != UNET_CM_SITES or n_all["attention_cm"] != UNET_CM_SITES
            or n_cm["attention"] != UNET_SELF_ATTN_SITES - UNET_CM_SITES
            or n_k1 != UNET_SELF_ATTN_SITES
            or n_all["attention_sm90"] != n_all["attention"]):
        raise SmokeFailure(f"the cm UNet eval launched {n_cm}, the two evals together {n_all}: "
                           f"want K5 at {UNET_CM_SITES} sites of the first and K1 at all "
                           f"{UNET_SELF_ATTN_SITES} of the second")
    check_k5_bf16(n_all, UNET_CM_SITES, "the cm UNet eval")
    rel = float((got - want).norm() / want.norm())
    # the attention sites' share of eps lies below bf16's resolution of the
    # residual stream on random weights, so this comparison mostly checks the
    # path; phase7_sites below holds K5's own output at each site
    print(f"phase7: UNet eps 64x64 latent b2, cm route (K5 at {n_cm['attention_cm']} sites, K1 "
          f"at {n_cm['attention']}) vs default route (K1 at {n_k1}), bf16: rel L2 {rel:.3e} "
          f"(tol 2e-2), max |eps| {float(want.abs().max()):.3f} ({card})")
    if not rel <= 2e-2:
        raise SmokeFailure(f"the cm route disagrees with the default route: rel L2 {rel:.3e}")
    sites = phase7_sites(bundle, dev, card, "bfloat16")
    sites_f32 = phase7_sites(bundle, dev, card, "float32")
    return launches, {k: sites[k] + sites_f32[k] for k in sites}


def phase7_sites(bundle, dev, card: str, dtype: str) -> dict:
    """The UNet's cm sites (levels 1 and 2 of the input and output blocks)
    with their weights in ``dtype`` (the bundle's bf16, or cast to f32), each
    through the cm block (K5's bf16 or f32 Hopper body) and through the
    default route (K1's sm90 or fused 3xTF32 body) on the same input at the
    render's plane (UNet batch 2); returns the launch counts."""
    import torch

    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch.models import unet as U
    from complex_prompt_diffusion_tpu_torch.pipeline import _tree_map

    sites, hw = [], 64
    input_plan, _, output_plan = M.build_plan(bundle.unet_cfg)
    blocks = list(zip(input_plan, bundle.unet_params["input_blocks"])) + list(
        zip(output_plan, bundle.unet_params["output_blocks"]))
    for plan, params in blocks:
        for desc, p in zip(plan, params):
            if desc[0] == "attn" and desc[1] % 128 == 0 and hw * hw > 128:
                sites += [(hw, desc[1], desc[2], blk["attn1"]) for blk in p["blocks"]]
            elif desc[0] == "down":
                hw //= 2
            elif desc[0] == "up":
                hw *= 2
    if len(sites) != UNET_CM_SITES:
        raise SmokeFailure(f"found {len(sites)} cm sites in the UNet, want {UNET_CM_SITES}")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(12)
    worst = 0.0
    reset_launches()
    with torch.inference_mode():
        for side, c, heads, p in sites:
            p = _tree_map(lambda a: a.to(dt), p)
            x = torch.randn((2, side * side, c), generator=gen, device=dev).to(dt)
            got = U._cross_attention(p, x, None, heads, attn_route="cm")
            want = U._cross_attention(p, x, None, heads, attn_route="bsc")
            if not bool(torch.isfinite(got).all()):
                raise SmokeFailure(f"the {dtype} cm site at {side}^2 x {c} gave non-finite values")
            worst = max(worst, float((got.float() - want.float()).norm() / want.float().norm()))
    launches = read_launches()
    n = len(sites)
    if dtype == "bfloat16":
        check_k5_bf16(launches, n, "the bf16 cm sites")
        k1_body, k1_ok = "K1's sm90 body", launches["attention_sm90"] == n
    else:
        k5_ok = launches["attention_cm_f32_sm90"] == launches["attention_cm_sm90"] == n
        if launches["attention_cm"] != n or not k5_ok:
            raise SmokeFailure(f"the f32 cm sites launched {launches}: want K5's f32 body once "
                               f"at each of the {n} sites")
        k1_body = "K1's fused 3xTF32 body"
        k1_ok = launches["attention_f32_fused_sm90"] == n and not launches["attention_sm90"]
    if launches["attention"] != n or not k1_ok or launches["attention_f32_sm90"]:
        raise SmokeFailure(f"the {dtype} cm sites launched {launches}: want {k1_body} once at "
                           f"each of the {n} sites")
    body = "bf16 TMA + wgmma" if dtype == "bfloat16" else "3xTF32"
    tf32 = "" if dtype == "bfloat16" else ", TF32 off"
    print(f"phase7: the UNet's {n} cm sites in {dtype} (S 1024 / 256, d 80 / 160, UNet batch 2), "
          f"cm block (K5's {body} body) vs default route ({k1_body}){tf32}: worst rel L2 "
          f"{worst:.3e} (tol {TOL[dtype]:.0e}) ({card})")
    if not worst <= TOL[dtype]:
        raise SmokeFailure(f"a {dtype} cm site disagrees with the default route: rel L2 "
                           f"{worst:.3e}")
    return launches


def phase8(bundle, image, card: str, steps: int) -> dict:
    """k-family img2img (Euler Ancestral, strength 0.75) of one phase-2
    image at batch 1, with the canonical-K attention route on for the phase;
    returns its launch counts."""
    import importlib

    import torch

    from complex_prompt_diffusion_tpu_torch.pipeline import RenderConfig, img2img, img2img_t_enc

    attn = importlib.import_module(f"{PKG}.ops.attention")
    cfg = RenderConfig(steps=steps, sampler="Euler Ancestral", guidance_scale=7.5, width=512,
                       height=512, batch_size=1, seed=4, denoising_strength=0.75)
    n_run = min(steps, img2img_t_enc(cfg.denoising_strength, steps, "k") + 1)
    flag = attn._USE_KCANON
    attn._USE_KCANON = True
    try:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images, latents = img2img(bundle, image, "a pencil sketch of an astronaut", cfg=cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = read_launches()
    finally:
        attn._USE_KCANON = flag

    check_image(images, (1, 512, 512, 3))
    check_latents(latents, (1, 64, 64, 4))
    check_k5_bf16(launches, UNET_SELF_ATTN_SITES * n_run, "the k-family img2img")
    # K1: the encoder's and the decoder's d = 512 mid-blocks, nothing else
    check_wide(launches, 2, 1, "the k-family img2img under the kcanon route")
    per = unet_call_launches(bundle.unet_cfg, 64, 2)
    check_gn(launches, n_run, 1, 1, "the k-family img2img", cat_counts(per, n_run))
    k4 = per["k4_sm90"]
    if launches["conv3x3_sm90"] < k4 * n_run or launches["attention_sm90"]:
        raise SmokeFailure(f"conv3x3's sm90 body launched {launches['conv3x3_sm90']} times (want "
                           f"at least {k4} x {n_run} steps), K1's "
                           f"{launches['attention_sm90']} (want 0: K5 takes the UNet)")
    if launches["geglu_ff"] <= 0:
        raise SmokeFailure("kernel geglu_ff was not launched in the k-family img2img")
    print(f"phase8: img2img 512x512 b1 strength 0.75 Euler Ancestral {steps} ({n_run} steps "
          f"run) CFG 7.5, kcanon attention route, bf16 VAE encode and decode, on {card}: "
          f"{t1 - t0:.3f} s end to end; launches {json.dumps(launches)}; image mean "
          f"{float(images.mean()):.2f}")
    return launches


class ModelCalls:
    """Records the batch of every call of ``models.<name>``, which the
    pipeline calls through the module, while the block runs: wraps it and
    reads the batch of the third argument (the UNet's x, CLIP's tokens)."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        from complex_prompt_diffusion_tpu_torch import models as M

        self.batches, self._models, self._inner = [], M, getattr(M, self.name)

        def counted(cfg, params, x, *args, **kwargs):
            self.batches.append(int(x.shape[0]))
            return self._inner(cfg, params, x, *args, **kwargs)

        setattr(M, self.name, counted)
        return self

    @property
    def n(self) -> int:
        return len(self.batches)

    def __exit__(self, *exc):
        setattr(self._models, self.name, self._inner)


def check_unet_path(launches: dict, unet_cfg, ub: int, calls: int, decodes: int, encodes: int,
                    what: str, batch: int = 1, latent: int = 64,
                    decode_dtype: str = "bfloat16", encode_batch: int = 1,
                    model: int = 1) -> None:
    """A bf16 path of ``calls`` UNet calls at UNet batch ``ub`` (a ``latent``
    x ``latent`` input), ``decodes`` decodes at ``batch`` and ``encodes``
    encodes at ``encode_batch``: K1's sm90 body, K2, K3 and K4 (its sm90
    body) with exactly the launches ``unet_call_launches`` predicts a call
    times the calls (so none ran a plain twin); the VAE mid-block on K1's
    wide body once a bf16 decode and an encode, or on its 3xTF32 body once
    an f32 one (the VAE's ``decode_dtype``); nothing on the other f32
    bodies, K5 or the probes. ``model``: a rank's calls under that many
    tensor-parallel ranks (K1 on its heads, K2 on its hidden shard)."""
    from complex_prompt_diffusion_tpu_torch.ops.attention import f32_sm90_launches

    check_held(unet_cfg, latent, ub, None, what, model)
    per = unet_call_launches(unet_cfg, latent, ub, model=model)
    s = latent * latent  # the VAE mid-block's tokens
    f32_decode = decode_dtype == "float32"
    want_f32 = (decodes * f32_sm90_launches(batch, 1, s, s)
                + encodes * f32_sm90_launches(encode_batch, 1, s, s)) if f32_decode else 0
    want = {"attention_sm90": per["k1"] * calls, "attention_f32_sm90": want_f32,
            "geglu_ff": per["k2"] * calls, "conv3x3": per["k4"] * calls,
            "conv3x3_sm90": per["k4_sm90"] * calls, "conv3x3_narrow": per["k4_narrow"] * calls}
    got = {k: launches[k] for k in want}
    if got != want or per["k3"] != UNET_GN_CALLS or per["k3_cat"] not in (0, UNET_CAT_CALLS):
        raise SmokeFailure(f"{what} ({calls} UNet calls at UNet batch {ub}) launched {got}: want "
                           f"{want} ({per} a call)")
    check_gn(launches, calls, decodes, encodes, what, cat_counts(per, calls))
    if f32_decode:
        check_wide(launches, 0, batch, what, s=s)
    else:
        check_wide(launches, decodes, batch, what, s=s, more=((encodes, encode_batch),))
    others = {n: launches[n] for n in ("attention_f32_fused_sm90", "conv3x3_f32_sm90",
                                       "geglu_ff_f32_sm90", "attention_cm") + PROBES
              if launches[n]}
    if others:
        raise SmokeFailure(f"{what} launched kernels off its path: {others}")


# phase 12's renders: (label, RenderConfig fields, the NFE its sampler's code
# implies at SAMPLER_STEPS, or None where it depends on the data: the two
# adaptive integrators make 3 calls an iteration, at most 200 iterations)
SAMPLER_STEPS = 20
SAMPLER_RENDERS = (
    # the first step evaluates twice (the pseudo improved Euler step)
    ("PLMS", dict(sampler="PLMS"), SAMPLER_STEPS + 1),
    # one call a step
    ("DPM-Solver++ multistep order 2", dict(sampler="dpm_solver", solver_order=2,
                                            solver_method="multistep"), SAMPLER_STEPS),
    # jumps of 3 calls, the remainder (2) last: 6 x 3 + 2
    ("DPM-Solver++ singlestep order 3", dict(sampler="dpm_solver", solver_order=3,
                                             solver_method="singlestep"), SAMPLER_STEPS),
    ("DPM-Solver++ adaptive order 3", dict(sampler="dpm_solver", solver_order=3,
                                           solver_method="adaptive"), None),
    # one call at the start and one a step but the last
    ("UniPC bh2 order 2", dict(sampler="UniPC", solver_order=2, unipc_variant="bh2"),
     SAMPLER_STEPS),
    ("UniPC vary_coeff order 3", dict(sampler="UniPC", solver_order=3,
                                      unipc_variant="vary_coeff"), SAMPLER_STEPS),
    ("iPNDM", dict(sampler="iPNDM"), SAMPLER_STEPS),
    ("DPM Adaptive", dict(sampler="DPM Adaptive"), None),
    ("Blur", dict(sampler="Blur"), SAMPLER_STEPS),
)
ADAPTIVE_ORDER, ADAPTIVE_MAX_ITERS = 3, 200


def phase12(bundle, image, card: str) -> dict:
    """The sampler zoo at full width, batch 1 (bf16 UNet and decode): one
    txt2img render a sampler of ``SAMPLER_RENDERS``, UniPC twice with one
    seed (same bits), and a DDIM inversion round trip of ``image``'s
    latents. Each render's UNet calls against its NFE and its kernels'
    launches against its calls; returns the phase's launch counts."""
    import numpy as np
    import torch

    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch import schedules as S
    from complex_prompt_diffusion_tpu_torch.guidance import make_denoiser, stacked_context
    from complex_prompt_diffusion_tpu_torch.pipeline import (
        RenderConfig,
        decode_latents,
        encode_image,
        make_guidance_spec,
        txt2img,
    )
    from complex_prompt_diffusion_tpu_torch.samplers import ddim_encode, sample_ddim

    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def render(label, fields, nfe):
        cfg = RenderConfig(steps=SAMPLER_STEPS, guidance_scale=7.5, width=512, height=512,
                           batch_size=1, seed=0, **fields)
        reset_launches()
        torch.cuda.synchronize()
        with ModelCalls("unet_apply") as unet:
            t0 = time.perf_counter()
            _, latents = txt2img(bundle, "a lighthouse on a cliff at sunset", cfg=cfg,
                                 decode=False)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            images = decode_latents(bundle, latents)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        launches = read_launches()
        calls = unet.n
        check_latents(latents, (1, 64, 64, 4))
        check_image(images, (1, 512, 512, 3))
        if nfe is None:
            # order x iterations, at most max_iters iterations
            if not (calls > 0 and calls % ADAPTIVE_ORDER == 0
                    and calls <= ADAPTIVE_ORDER * ADAPTIVE_MAX_ITERS):
                raise SmokeFailure(f"{label} made {calls} UNet calls: want {ADAPTIVE_ORDER} an "
                                   f"iteration, at most {ADAPTIVE_MAX_ITERS} iterations")
        elif calls != nfe:
            raise SmokeFailure(f"{label} made {calls} UNet calls, its sampler implies {nfe}")
        check_unet_path(launches, bundle.unet_cfg, 2, calls, 1, 0, f"the {label} render")
        add(launches)
        print(f"phase12: {label} 512x512 b1 {SAMPLER_STEPS} steps CFG 7.5 on {card}: NFE "
              f"{calls}{' (data-dependent)' if nfe is None else ''}, UNet calls {calls}; K1 "
              f"{launches['attention']} (sm90 {launches['attention_sm90']}), K2 "
              f"{launches['geglu_ff']}, K3 {launches['group_norm']} ({launches['group_norm calls']}"
              f" calls), K4 {launches['conv3x3']}; sampling {t1 - t0:.3f} s = "
              f"{(t1 - t0) / calls:.4f} s a UNet call, render with bf16 decode {t2 - t0:.3f} s; "
              f"latents std {float(latents.std()):.4f}", flush=True)
        return latents

    for label, fields, nfe in SAMPLER_RENDERS:
        latents = render(label, fields, nfe)
        if fields["sampler"] == "UniPC" and fields["unipc_variant"] == "bh2":
            again = render(label + " (again, same seed)", fields, nfe)
            if not torch.equal(latents, again):
                raise SmokeFailure("UniPC rendered twice with one seed gave different bits")
            print(f"phase12: UniPC bh2 twice with seed 0: the same bits ({card})")

    # DDIM inversion round trip of the image's latents, 20 steps each way
    spec = make_guidance_spec(bundle, "a photograph of an astronaut riding a horse")
    cross_kv = M.precompute_cross_kv(bundle.unet_cfg, bundle.unet_params,
                                     stacked_context(spec, 1))

    def unet_eps(x, t, ctx):
        return M.unet_apply(bundle.unet_cfg, bundle.unet_params, x, t, ctx, cross_kv=cross_kv)

    eps_fn, _ = make_denoiser(unet_eps, spec, model_sigmas=bundle.tables.sigmas)
    itables = S.make_inference_tables(bundle.tables, SAMPLER_STEPS)
    ucs = np.full(itables.num_steps, 7.5)
    reset_launches()
    torch.cuda.synchronize()
    with ModelCalls("unet_apply") as unet, torch.inference_mode():
        t0 = time.perf_counter()
        z0 = encode_image(bundle, image)
        x_T = ddim_encode(eps_fn, z0, itables, itables.num_steps, ucs)
        back, _ = sample_ddim(eps_fn, x_T, itables, ucs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    launches = read_launches()
    calls = unet.n
    if calls != 2 * itables.num_steps:
        raise SmokeFailure(f"the DDIM inversion round trip made {calls} UNet calls, want "
                           f"{2 * itables.num_steps}")
    check_latents(back, (1, 64, 64, 4))
    check_unet_path(launches, bundle.unet_cfg, 2, calls, 0, 1, "the DDIM inversion round trip")
    add(launches)
    rel = float((back - z0).norm() / z0.norm())
    print(f"phase12: DDIM inversion round trip of a phase-2 image's latents at b1, "
          f"{itables.num_steps} steps each way, CFG 7.5, on {card}: latent relRMSE {rel:.4f}; "
          f"{calls} UNet calls in {t1 - t0:.3f} s; x_T std {float(x_T.std()):.4f}", flush=True)
    if not np.isfinite(rel):
        raise SmokeFailure(f"the DDIM inversion round trip is not finite: {rel}")
    return total


def phase9(bundle, dev, card: str) -> dict:
    """The Winograd probe on the UNet's own ResBlock conv weights at the
    batch-1 render's planes, against the same convs through K4: in bf16 on
    K6's Hopper body, in f32 on its 3xTF32 body (and against the plain twin
    at 1e-5, TF32 off); then the 20 convs of each dtype timed on both of
    K6's bodies, through K4 and through cuDNN; returns its launch counts."""
    return winograd_probe("phase9", "the UNet's", bundle.unet_cfg, bundle.unet_params, dev, card)


def winograd_probe(tag: str, what: str, unet_cfg, unet_params, dev, card: str) -> dict:
    """Phase 9's probe of K6 on the ResBlock convs of ``unet_cfg``'s 32^2 and
    16^2 planes (a 64x64 latent) at UNet batch 2, with ``unet_params``'
    weights, printed under ``tag``: K6 against K4 in both dtypes (none on
    K6's first body), the f32 body against its twin, the convs timed on
    K6's bodies, K4 and cuDNN; returns its launch counts."""
    import torch
    import torch.nn.functional as F

    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch.models import layers as L
    from complex_prompt_diffusion_tpu_torch.ops.probes.winograd import (
        wino3x3,
        wino3x3_plain,
        wino3x3_plan,
        wino3x3_prior,
        winograd_weights,
    )
    from complex_prompt_diffusion_tpu_torch.tools.hotcold import METHOD, graph_ms

    # (plane side, conv params) of every ResBlock conv, walking the plan from
    # a 64x64 latent
    convs, hw = [], 64
    input_plan, _, output_plan = M.build_plan(unet_cfg)
    blocks = list(zip(input_plan, unet_params["input_blocks"])) + list(
        zip(output_plan, unet_params["output_blocks"]))
    for plan, params in blocks:
        for desc, p in zip(plan, params):
            if desc[0] == "res":
                convs += [(hw, p["in_conv"]), (hw, p["out_conv"])]
            elif desc[0] == "down":
                hw //= 2
            elif desc[0] == "up":
                hw *= 2
    convs = [(side, p) for side, p in convs if side in (16, 32)]
    gen = torch.Generator(device=dev).manual_seed(13)
    cases = []
    for side, p in convs:
        co, c = p["weight"].shape[:2]
        x = torch.randn((2, side, side, c), generator=gen, device=dev).to(torch.bfloat16)
        cases.append((x, p, p["weight"].permute(2, 3, 1, 0)))  # HWIO view of the weight
    # the same convs in f32 (an f32 UNet's: weights, bias and input cast)
    cases32 = [(x.float(), {k: v.float() for k, v in p.items()}, k.float()) for x, p, k in cases]
    want_sm90 = sum(wino3x3_plan(*x.shape, k.shape[3]).launches for x, _, k in cases)
    want_f32 = sum(wino3x3_plan(*x.shape, k.shape[3], dtype=torch.float32).launches
                   for x, _, k in cases32)

    reset_launches()
    worst = {"bf16": 0.0, "f32": 0.0, "f32 twin": 0.0}
    with torch.inference_mode():
        for (x, p, k_hwio), (x32, p32, k32) in zip(cases, cases32):
            for dt, got, want in (("bf16", wino3x3(x, k_hwio, p["bias"]), L.conv2d(p, x)),
                                  ("f32", wino3x3(x32, k32, p32["bias"]), L.conv2d(p32, x32))):
                rel = float((got.float() - want.float()).norm() / want.float().norm())
                if not (rel <= TOL["bfloat16"]) or not bool(torch.isfinite(got).all()):
                    raise SmokeFailure(f"the Winograd probe ({dt}) disagrees with K4 on a "
                                       f"{tuple(k_hwio.shape)} conv: rel L2 {rel:.3e}")
                worst[dt] = max(worst[dt], rel)
                if dt == "f32":  # K6's f32 body against its twin: max |a - b| / max |b|
                    twin = wino3x3_plain(x32, winograd_weights(k32), p32["bias"])
                    rel = rel_err(got, twin)[1]
                    if not rel <= 1e-5:
                        raise SmokeFailure(f"K6's f32 body disagrees with its plain twin on a "
                                           f"{tuple(k32.shape)} conv: {rel:.3e} (tol 1e-5)")
                    worst["f32 twin"] = max(worst["f32 twin"], rel)
    torch.cuda.synchronize()
    launches = read_launches()
    n = len(cases)
    if (launches["winograd_sm90"] != want_sm90 or launches["winograd_f32_sm90"] != want_f32
            or launches["winograd"] != want_sm90 + want_f32 or launches["conv3x3"] != 2 * n
            or launches["conv3x3_sm90"] != n or launches["conv3x3_f32_sm90"] != n or not cases):
        raise SmokeFailure(f"the probe phase launched {launches} for {n} convs of each dtype "
                           f"(want {want_sm90} kernels of K6's bf16 Hopper body and {want_f32} "
                           f"of its f32 one by their plans, none of its first body, {n} of K4's "
                           f"sm90 body and {n} of its f32 one)")
    times = {}
    with torch.inference_mode():
        for dt, cs in (("bf16", cases), ("f32", cases32)):
            us = [winograd_weights(k).to(x.dtype) for x, _, k in cs]
            ws = [p["weight"].contiguous(memory_format=torch.channels_last) for _, p, _ in cs]
            times[dt] = {
                "K6 with the weight transform in each call": graph_ms(
                    lambda cs=cs: [wino3x3(x, k, p["bias"]) for x, p, k in cs]),
                "K6 Hopper body": graph_ms(lambda cs=cs, us=us: [
                    wino3x3(x, k, p["bias"], u=u) for (x, p, k), u in zip(cs, us)]),
                "K6 first body": graph_ms(lambda cs=cs, us=us: [
                    wino3x3_prior(x, k, p["bias"], u=u) for (x, p, k), u in zip(cs, us)]),
                "K4": graph_ms(lambda cs=cs: [L.conv2d(p, x) for x, p, _ in cs]),
                "cuDNN": graph_ms(lambda cs=cs, ws=ws: [
                    F.conv2d(x.permute(0, 3, 1, 2), w, p["bias"], padding=1)
                    for (x, p, _), w in zip(cs, ws)]),
            }
    for dt in ("bf16", "f32"):
        t = times[dt]
        print(f"{tag}: Winograd probe on {what} {n} ResBlock convs of the 32^2 and 16^2 "
              f"planes (UNet batch 2) in {dt}, U made ahead, on {card}: "
              f"{', '.join(f'{k} {v:.4f} ms' for k, v in t.items())}; Hopper / first body "
              f"{t['K6 Hopper body'] / t['K6 first body']:.3f}, / K4 "
              f"{t['K6 Hopper body'] / t['K4']:.3f} ({METHOD})")
    print(f"{tag}: worst rel L2 vs K4 {worst['bf16']:.3e} (bf16), {worst['f32']:.3e} (f32) (tol "
          f"2e-2); f32 body vs its plain twin {worst['f32 twin']:.3e} (tol 1e-5, TF32 off); "
          f"launches {json.dumps(launches)} ({card})")
    return launches


def phase10(dev, card: str) -> dict:
    """The probes of the TPU tuning scripts: every mode and flag against its
    plain twin at small shapes, K8's full mode against K3's bits at the
    scripts' planes, the SASS MMA counts of the attention ablations and the
    GroupNorm modes' statistics, then every script variant at the scripts'
    shapes; returns the timed run's launch counts."""
    import torch

    from complex_prompt_diffusion_tpu_torch.tools import probe_attention as PA
    from complex_prompt_diffusion_tpu_torch.tools import probe_groupnorm as PG
    from complex_prompt_diffusion_tpu_torch.tools.hotcold import METHOD

    checks = PA.check_small(dev) + PG.check_small(dev) + PG.check_k3_bits(dev)
    for label, err, tol in checks:
        print(f"phase10: {label}: error {err:.3e} (tol {tol:.0e}) ({card})")
    copies = PG.check_copies(dev)
    print(f"phase10: every K9 mode at the copy scripts' shapes, both bodies: {len(copies)} "
          f"copies, {sum(1 for c in copies if c[1])} with a differing element (tol 0) ({card})")
    bad = [c for c in checks + copies if not c[1] <= c[2]]
    if bad:
        raise SmokeFailure(f"{len(bad)} probe variants disagree with their plain twins: {bad}")
    counts = PA.sass_counts()
    lines, ok = PA.check_sass(counts)
    gn_lines, gn_ok = PG.check_sass(counts)
    for ln in lines + gn_lines:
        print(f"phase10: SASS {ln}")
    if not ok:
        raise SmokeFailure("an ablated attention mode lost MMAs of the steps it keeps")
    if not gn_ok:
        raise SmokeFailure("an ablated GroupNorm mode lost the statistics it keeps")

    print(f"phase10: the TPU probe scripts' variants at their shapes on {card}: {METHOD}, "
          f"L2 hot (one input) and cold (inputs rotated past 2 x 50 MB); bound = "
          f"max(flops / peak, bytes / 3.35 TB/s)", flush=True)
    reset_launches()
    rows = PA.run(dev, card) + PG.run(dev, card)
    torch.cuda.synchronize()
    launches = read_launches()
    rate, best = PG.streaming_rate(rows)
    print(f"phase10: {len(rows)} probe rows; K9 streaming rate {rate:.3f} TB/s (cold, "
          f"{best.script} {best.variant} {best.shape}) against the nominal 3.35 TB/s of the "
          f"bytes bounds ({card})")
    for name in PHASE10_PROBES:
        if launches[name] <= 0:
            raise SmokeFailure(f"probe kernel {name} was not launched in phase 10")
    print(f"phase10: launches {json.dumps(launches)}")
    return launches


def phase11(dev, card: str, steps: int) -> dict:
    """The exact-f32 render: (a) one SD-1.5 UNet eval cast to f32 on a 16x16
    latent, kernels against the plain twins on CPU copies (TF32 off); (b)
    txt2img at 512x512, batch 1, DDIM, CFG 7.5 with the UNet in f32, then the
    f32 decode; (c) the default bundle, ``ModelBundle.random()`` with no
    arguments (the tiny config on the card, f32 UNet), renders a short
    txt2img. Returns (b)'s and (c)'s launch counts."""
    import torch

    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch.ops.attention import f32_sm90_launches
    from complex_prompt_diffusion_tpu_torch.pipeline import (
        ModelBundle,
        RenderConfig,
        _tree_map,
        decode_latents,
        txt2img,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bundle = ModelBundle.random("sd15", seed=0, device=dev).cast("float32")
    if bundle.unet_cfg.dtype != "float32" or bundle.vae_cfg.dtype != "float32":
        raise SmokeFailure(f"the f32 bundle runs its UNet in {bundle.unet_cfg.dtype}, its VAE "
                           f"in {bundle.vae_cfg.dtype}")

    # (a) one UNet eval on a 16x16 latent (S = 256 self-attention reaches K1;
    # level 0 on the 16^2 plane, inside the conv gate)
    cpu = torch.device("cpu")
    gen = torch.Generator(device=cpu).manual_seed(17)
    x = torch.randn((2, 16, 16, 4), generator=gen)
    t = torch.tensor([801, 801])
    ctx = torch.randn((2, 77, 768), generator=gen)
    reset_launches()
    with torch.inference_mode():
        got = M.unet_apply(bundle.unet_cfg, bundle.unet_params, x.to(dev), t.to(dev),
                           ctx.to(dev)).cpu()
        n = read_launches()
        want = M.unet_apply(bundle.unet_cfg, _tree_map(lambda a: a.to(cpu), bundle.unet_params),
                            x, t, ctx)
    want_ff = geglu_launches_per_step(1, "float32", latent=16)
    if (n["conv3x3"] != UNET_CONVS_16_LATENT or n["conv3x3_f32_sm90"] != UNET_CONVS_16_LATENT - 2
            or n["conv3x3_sm90"] or n["geglu_ff"] != want_ff
            or n["geglu_ff_f32_sm90"] != want_ff or n["attention_sm90"]):
        raise SmokeFailure(f"the f32 16x16 UNet eval launched {n}: want K4 {UNET_CONVS_16_LATENT} "
                           f"times, all but conv_in (C = 4) and the out conv (Co = 4) on its f32 "
                           f"body, K2's f32 body {want_ff} kernels for its {UNET_FF_SITES} calls "
                           f"(by their plans), no bf16 body")
    rel = float((got - want).norm() / want.norm())
    print(f"phase11: f32 UNet eps 16x16 latent b2 (TF32 off), CUDA kernels vs CPU plain twins: "
          f"rel L2 {rel:.3e} (tol 1e-4); K4 {n['conv3x3']} convs, {n['conv3x3_f32_sm90']} on "
          f"its 3xTF32 body; K2 {UNET_FF_SITES} calls, {n['geglu_ff_f32_sm90']} kernels on its "
          f"f32 body ({card})", flush=True)
    if not rel <= 1e-4:
        raise SmokeFailure(f"the f32 UNet's kernel path disagrees with the plain path: {rel:.3e}")

    # (b) the exact-f32 batch-1 render
    cfg = RenderConfig(steps=steps, sampler="DDIM", eta=0.0, guidance_scale=7.5,
                       width=512, height=512, batch_size=1, seed=5)
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, latents = txt2img(bundle, "a lighthouse on a rocky coast, exact f32", cfg=cfg,
                         decode=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    before = read_launches()
    images = decode_latents(bundle, latents)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_launches()

    check_image(images, (1, 512, 512, 3))
    check_latents(latents, (1, 64, 64, 4))
    check_geglu(launches, 1, steps, "the f32 render", "float32")
    want_conv = UNET_CONVS_PER_CALL_B1 * steps
    if (launches["conv3x3"] != want_conv or launches["conv3x3_f32_sm90"] != want_conv
            or launches["conv3x3_sm90"]):
        raise SmokeFailure(f"the f32 render ran K4 {launches['conv3x3']} times, its f32 body "
                           f"{launches['conv3x3_f32_sm90']}, its bf16 body "
                           f"{launches['conv3x3_sm90']}: want {want_conv}, all on the f32 body")
    want_dec = f32_sm90_launches(1, 1, 4096, 4096)
    if (launches["attention_f32_fused_sm90"] != UNET_SELF_ATTN_SITES * steps
            or launches["attention_f32_sm90"] != want_dec or launches["attention_sm90"]
            or launches["attention"] != UNET_SELF_ATTN_SITES * steps + want_dec):
        raise SmokeFailure(f"K1 in the f32 render: {launches}; want every UNet self-attention "
                           f"site on the fused 3xTF32 body ({UNET_SELF_ATTN_SITES} x {steps}) and "
                           f"the decode's mid-block on the unfused one ({want_dec} kernels)")
    check_gn(launches, steps, 1, 0, "the f32 render")
    check_wide(launches, 0, 1, "the f32 render")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"phase11: exact-f32 txt2img 512x512 b1 DDIM {steps} steps CFG 7.5 (UNet f32, TF32 "
          f"off; f32 decode) on {card}: seconds to image {t2 - t0:.3f} s end to end (incl. "
          f"prompt encode and first-call warm-up), {(t1 - t0) / steps:.4f} s/step, decode "
          f"{1000 * (t2 - t1):.2f} ms, peak memory {peak_gb:.2f} GiB; K2 "
          f"{launches['geglu_ff_f32_sm90']} kernels on its f32 body "
          f"({geglu_launches_per_step(1, 'float32')} a step), K4 {launches['conv3x3_f32_sm90']} "
          f"convs on its f32 body; decode K1 kernels "
          f"{launches['attention'] - before['attention']}", flush=True)
    print(f"phase11: launches {json.dumps(launches)}; latents mean {float(latents.mean()):.5f} "
          f"std {float(latents.std()):.5f}; image mean {float(images.mean()):.2f}")

    # (c) the default bundle: ModelBundle.random() with no arguments
    default = ModelBundle.random()
    reset_launches()
    images, latents = txt2img(default, "a cat", cfg=RenderConfig(
        steps=4, width=128, height=128, batch_size=2, seed=6))
    torch.cuda.synchronize()
    n = read_launches()
    check_image(images, (2, 32, 32, 3))
    check_latents(latents, (2, 16, 16, 4))
    if (default.unet_cfg.dtype != "float32" or n["geglu_ff_f32_sm90"] <= 0
            or n["geglu_ff"] != n["geglu_ff_f32_sm90"] or n["conv3x3_f32_sm90"] <= 0
            or n["conv3x3_narrow"] <= 0 or n["conv3x3_sm90"]
            or n["conv3x3"] != n["conv3x3_f32_sm90"] + n["conv3x3_narrow"]):
        raise SmokeFailure(f"the default bundle (UNet {default.unet_cfg.dtype}) rendered with "
                           f"launches {n}: want K2 on its f32 body and K4 on its 3xTF32 body "
                           f"(32 -> 32, 96 -> 32 among its convs) and its narrow bodies (conv_in, "
                           f"the out conv), none on the generic body")
    print(f"phase11: ModelBundle.random() (no arguments: tiny, UNet {default.unet_cfg.dtype}, on "
          f"{default.device}) txt2img 128x128 b2 4 steps: images {tuple(images.shape)} "
          f"{images.dtype}; launches {json.dumps(n)} ({card})")
    return launches, n


SD21_STEPS = 50  # DDIM steps of phase 13's b4 render
SD21_K_STEPS = 20  # DPM++ 2M Karras steps of its b1 render


def unet_call_launches(cfg, latent: int, ub: int, dtype: str = "bfloat16", deep_at=None,
                       model: int = 1) -> dict:
    """What one UNet call of ``cfg`` on a ``latent`` x ``latent`` input at
    UNet batch ``ub`` launches, from its sites (``kernel_cases.unet_sites``,
    the shallow pass's with ``deep_at``, token reduction as ``cfg`` sets it,
    a rank's under ``model`` tensor-parallel ranks) and the kernels' own
    rules: K1's sm90 body once at every self-attention site above
    ``SHORT_KV`` keys, K2 the kernels of each FF site's plan at its rows
    (and the rank's hidden width), K3 one call a GroupNorm ("k3_cat" of
    them on its two-source form where the up path is fused at this batch
    and dtype, ``models.unet.skip_cat_fused``; "k3_cat_launches" their
    kernels and "k3_cat_slab" those on its slab form, by
    ``group_norm_cat_plan``), K4 the convs its gate admits (and of those,
    the ones on its sm90 body, its f32 body, its narrow bodies and its
    generic body, by ``k4_body``; the fused up path's in_convs split in
    two)."""
    import torch

    from complex_prompt_diffusion_tpu_torch.models.layers import conv3x3_wanted
    from complex_prompt_diffusion_tpu_torch.models.unet import skip_cat_fused
    from complex_prompt_diffusion_tpu_torch.ops.attention import SHORT_KV
    from complex_prompt_diffusion_tpu_torch.ops.conv import k4_body
    from complex_prompt_diffusion_tpu_torch.ops.groupnorm import group_norm_cat_plan
    from complex_prompt_diffusion_tpu_torch.ops.mlp import geglu_plan
    from complex_prompt_diffusion_tpu_torch.tools.kernel_cases import unet_sites

    dt = getattr(torch, dtype)
    sites = unet_sites(cfg, latent, deep_at, model, skip_cat_fused(ub, dt))
    gated = [(s, c, co) for s, c, co in sites["conv"]
             if conv3x3_wanted(torch.empty((ub, s, s, c), device="meta"), (co, c, 3, 3))]
    bodies = collections.Counter(k4_body(dt, c, co) for _, c, co in gated)
    # the form, not its tiles, sets the launches: the card's SM count is not needed
    cat = [group_norm_cat_plan(ub, s * s, ca, cb, 32, 132, dt) for s, ca, cb in sites["gn_cat"]]
    return {"k1": sum(1 for _, skv, _, _ in sites["self_attn"] if skv > SHORT_KV),
            "k2": sum(geglu_plan(ub * rows, ch, h4[0] if h4 else 4 * ch, dt).launches
                      for rows, ch, *h4 in sites["ff_rows"]),
            "k3": sites["gn"], "k3_cat": len(cat),
            "k3_cat_launches": sum(p.launches for p in cat),
            "k3_cat_slab": sum(p.launches for p in cat if p.form == "slab"), "k4": len(gated),
            "k4_sm90": bodies["bf16_sm90"], "k4_f32": bodies["f32_sm90"],
            "k4_narrow": bodies["narrow"], "k4_generic": bodies["generic"]}


def scratch_dir(need_bytes: int) -> str:
    """A new temporary directory with ``need_bytes`` free: under the
    temporary directory, or /dev/shm where that disk is short."""
    import shutil
    import tempfile

    for base in (tempfile.gettempdir(), "/dev/shm"):
        if Path(base).is_dir() and shutil.disk_usage(base).free >= need_bytes:
            return tempfile.mkdtemp(prefix="ckpt-", dir=base)
    raise SmokeFailure(f"no temporary directory has {need_bytes} bytes free for the checkpoint")


def tree_mismatches(got, want, pre: str = "") -> list:
    """Paths where two tensor trees differ in structure, dtype or bits."""
    import torch

    if isinstance(want, dict):
        if not isinstance(got, dict) or got.keys() != want.keys():
            return [pre or "/"]
        return [m for k in want for m in tree_mismatches(got[k], want[k], f"{pre}/{k}")]
    if isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            return [pre]
        return [m for i, (a, b) in enumerate(zip(got, want))
                for m in tree_mismatches(a, b, f"{pre}/{i}")]
    ok = got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)
    return [] if ok else [pre]


def phase13(dev, card: str) -> dict:
    """SD 2.1-v at full width, 768x768: (a) random SD 2.1 trees (seed 0)
    written as a CompVis fp16 checkpoint by ``tools/synth_checkpoint.py``,
    loaded through ``config.bundle_from_config`` with v2-inference-v's model
    section (UNet cast to bf16 on the host) and held to what was written;
    (b) txt2img b4, DDIM 50, CFG 7.5, the exact-f32 decode; (c) txt2img b1,
    DPM++ 2M Karras 20 (the v denoiser of the sigma family), bf16 decode;
    (d) one UNet eval on a 24x24 latent (S = 576, 144, 36, 9), CUDA
    kernels against the CPU plain twins. Every launch count is predicted
    from the config and the kernels' plans. Returns the launch counts of
    (b), (c) and (d) by path."""
    import torch

    from complex_prompt_diffusion_tpu_torch import config as CONF
    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch import schedules as S
    from complex_prompt_diffusion_tpu_torch.pipeline import (
        RenderConfig,
        _tree_map,
        decode_latents,
        txt2img,
    )
    from complex_prompt_diffusion_tpu_torch.tools.kernel_cases import SD21_LATENT

    side, s = SD21_LATENT, SD21_LATENT ** 2
    px = 8 * side
    # (a) the checkpoint, written and loaded at full width
    unet_cfg = M.UNetConfig.sd21()
    bundle, took = synth_bundle(
        dev, unet_cfg, M.VAEConfig.sd(), M.CLIPTextConfig.sd21(), "openclip",
        lambda path: CONF.bundle_from_config(V2_INFERENCE_V_MODEL, checkpoint_path=path,
                                             dtype="bfloat16", device=dev))
    fields = (bundle.version, bundle.parameterization, bundle.clip_layer,
              bundle.tokenizer.pad_id, bundle.unet_cfg, bundle.vae_cfg.dtype)
    want_fields = ("sd2", "v", "penultimate", 0,
                   dataclasses.replace(unet_cfg, dtype="bfloat16"), "float32")
    if fields != want_fields:
        raise SmokeFailure(f"the loaded SD 2.1 checkpoint's bundle says {fields}, want "
                           f"{want_fields}")
    print(f"phase13: SD 2.1-v checkpoint (CompVis layout, fp16, random weights from seed 0): "
          f"{took} through config.bundle_from_config (v2-inference-v's model section; UNet cast "
          f"to bf16 on the host); version sd2, parameterization v, clip_layer penultimate, pad "
          f"id 0 ({card})", flush=True)

    prompt = "a photograph of a lighthouse on a rocky coast at sunset"
    paths = {}
    # (b) batch 4, DDIM 50, the exact-f32 decode
    per8 = unet_call_launches(bundle.unet_cfg, side, 8)
    if per8["k3"] != UNET_GN_CALLS or per8["k4"]:
        raise SmokeFailure(f"the SD 2.1 UNet call at UNet batch 8 has {per8}: want "
                           f"{UNET_GN_CALLS} GroupNorms and no conv inside K4's gate")
    cfg = RenderConfig(steps=SD21_STEPS, sampler="DDIM", eta=0.0, guidance_scale=7.5,
                       width=px, height=px, batch_size=4, seed=0)
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    with ModelCalls("unet_apply") as unet_calls:
        t0 = time.perf_counter()
        _, latents = txt2img(bundle, prompt, cfg=cfg, decode=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        images = decode_latents(bundle, latents)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    launches = read_launches()
    calls = unet_calls.n
    check_latents(latents, (4, side, side, 4))
    check_image(images, (4, px, px, 3))
    nfe = S.make_inference_tables(bundle.tables, SD21_STEPS).num_steps
    if calls != nfe:
        raise SmokeFailure(f"the SD 2.1 b4 render made {calls} UNet calls, want {nfe}")
    check_unet_path(launches, bundle.unet_cfg, 8, calls, 1, 0, "the SD 2.1 b4 render", batch=4,
                    latent=side, decode_dtype="float32")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"phase13: SD 2.1-v txt2img {px}x{px} b4 DDIM {SD21_STEPS} steps CFG 7.5, bf16 UNet, "
          f"exact-f32 decode (TF32 off) on {card}: sampling {t1 - t0:.3f} s = "
          f"{(t1 - t0) / SD21_STEPS:.4f} s/step (incl. prompt encode and first-call warm-up), "
          f"decode {1000 * (t2 - t1) / 4:.2f} ms/img, end to end {4 / (t2 - t0):.4f} img/s, peak "
          f"memory {peak_gb:.2f} GiB; UNet calls {calls}; K1 sm90 {launches['attention_sm90']} "
          f"({per8['k1']} a call), 3xTF32 {launches['attention_f32_sm90']}, K2 "
          f"{launches['geglu_ff']} ({per8['k2']} a call), K3 {launches['group_norm']} kernels for "
          f"{launches['group_norm calls']} calls", flush=True)
    print(f"phase13: b4 launches {json.dumps(launches)}; latents mean {float(latents.mean()):.5f} "
          f"std {float(latents.std()):.5f}; image mean {float(images.mean()):.2f}")
    paths["sd21_txt2img_b4"] = launches

    # (c) batch 1, DPM++ 2M Karras 20, the bf16 decode
    bundle16 = bundle.cast_vae("bfloat16")
    per2 = unet_call_launches(bundle.unet_cfg, side, 2)
    if per2["k4"] != per2["k4_sm90"] or not per2["k4"]:
        raise SmokeFailure(f"the SD 2.1 UNet call at UNet batch 2 has {per2}: want K4 convs "
                           f"(the 24^2 plane), all on the sm90 body")
    cfg = RenderConfig(steps=SD21_K_STEPS, sampler="DPM++ 2m", sigma_schedule="karras",
                       guidance_scale=7.5, width=px, height=px, batch_size=1, seed=1)
    reset_launches()
    torch.cuda.synchronize()
    with ModelCalls("unet_apply") as unet_calls:
        t0 = time.perf_counter()
        _, latents = txt2img(bundle16, prompt, cfg=cfg, decode=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        images = decode_latents(bundle16, latents)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    launches = read_launches()
    decode_latents(bundle16, latents)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    calls = unet_calls.n
    check_latents(latents, (1, side, side, 4))
    check_image(images, (1, px, px, 3))
    if calls != SD21_K_STEPS:
        raise SmokeFailure(f"the SD 2.1 b1 render made {calls} UNet calls, want {SD21_K_STEPS}")
    check_unet_path(launches, bundle.unet_cfg, 2, calls, 1, 0, "the SD 2.1 b1 render",
                    latent=side)
    print(f"phase13: SD 2.1-v txt2img {px}x{px} b1 DPM++ 2M Karras {SD21_K_STEPS} steps CFG 7.5 "
          f"(the v denoiser), bf16 UNet and decode, on {card}: seconds to first image "
          f"{t2 - t0:.3f} s end to end (incl. prompt encode and first-call warm-up), "
          f"{(t1 - t0) / SD21_K_STEPS:.4f} s/step, decode {1000 * (t2 - t1):.2f} ms (first call), "
          f"{1000 * (t3 - t2):.2f} ms (second); K1 sm90 {launches['attention_sm90']}, wide "
          f"{launches['attention_bf16_wide_sm90']}, K4 sm90 {launches['conv3x3_sm90']} "
          f"({per2['k4']} a call), K2 {launches['geglu_ff']}, K3 {launches['group_norm']} "
          f"kernels for {launches['group_norm calls']} calls", flush=True)
    print(f"phase13: b1 launches {json.dumps(launches)}; latents std {float(latents.std()):.5f}")
    paths["sd21_txt2img_b1_dpmpp2m"] = launches
    del bundle16
    torch.cuda.empty_cache()

    # (d) one UNet eval on a 24x24 latent against the CPU plain twins
    cpu = torch.device("cpu")
    g = torch.Generator(device=cpu).manual_seed(19)
    x = torch.randn((2, 24, 24, 4), generator=g)
    t = torch.tensor([801, 801])
    ctx = torch.randn((2, 77, bundle.clip_cfg.hidden_size), generator=g)
    reset_launches()
    with torch.inference_mode():
        got = M.unet_apply(bundle.unet_cfg, bundle.unet_params, x.to(dev), t.to(dev),
                           ctx.to(dev)).cpu()
        n = read_launches()
        want = M.unet_apply(bundle.unet_cfg, _tree_map(lambda a: a.to(cpu), bundle.unet_params),
                            x, t, ctx)
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    print(f"phase13: SD 2.1 UNet eps 24x24 latent b2 (self-attention S = 576, 144 on K1 at d = "
          f"64; 36, 9 on the short path), bf16 weights, CUDA kernels vs CPU plain twins: rel L2 "
          f"{rel:.3e} (tol 5e-2, bf16); K1 sm90 {n['attention_sm90']}, K4 {n['conv3x3']} "
          f"({n['conv3x3_sm90']} sm90), K2 {n['geglu_ff']} ({card})", flush=True)
    check_unet_path(n, bundle.unet_cfg, 2, 1, 0, 0, "the 24x24 SD 2.1 UNet eval", latent=24)
    if not rel <= 5e-2:
        raise SmokeFailure(f"the SD 2.1 UNet's kernel path disagrees with the plain path: "
                           f"{rel:.3e}")
    paths["sd21_unet_eval_24"] = n
    return paths


# phase 14: the reference's schedule table (tests/test_torch_prompts.py holds
# it against the JAX package's lark parser), at 10 steps
SCHEDULE_TABLE = (
    ("test", [[10, "test"]]),
    ("a [b:3]", [[3, "a "], [10, "a b"]]),
    ("a [b: 3]", [[3, "a "], [10, "a b"]]),
    ("a [[[b]]:2]", [[2, "a "], [10, "a [[b]]"]]),
    ("[(a:2):3]", [[3, ""], [10, "(a:2)"]]),
    ("a [b : c : 1] d", [[1, "a b  d"], [10, "a  c  d"]]),
    ("a[b:[c:d:2]:1]e", [[1, "abe"], [2, "ace"], [10, "ade"]]),
    ("a [unbalanced", [[10, "a [unbalanced"]]),
    ("a [b:.5] c", [[5, "a  c"], [10, "a b c"]]),
    ("a [{b|d{:.5] c", [[10, "a [{b|d{:.5] c"]]),
    ("((a][:b:c [d:3]", [[3, "((a][:b:c "], [10, "((a][:b:c d"]]),
)
PROMPT_STEPS = 20  # DDIM steps of phase 14's b1 3-factor render
PROMPT_B4_STEPS = 10  # and of its b4 one
RENDER_STEPS = 10  # DDIM steps of the render engine's frames


def phase14(bundle, image, card: str) -> dict:
    """The prompt algebra at full width (bf16 UNet and VAE, 512x512): (a) the
    schedule grammar, (b) a 3-factor masked prompt with the guidance
    switches at b1 and one guided eps against the CPU twins, (c) the same
    spec at b4, (d) the manager's JSON API (txt2img of a weighted prompt,
    img2img with a mask through RePaint), (e) the render engine, independent
    and feedback frames. Returns the launch counts by path."""
    import numpy as np
    import torch

    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch.guidance import (
        GuidanceConfig,
        GuidanceSpec,
        cfg_epsilon,
    )
    from complex_prompt_diffusion_tpu_torch.manager import DiffusionModelManager
    from complex_prompt_diffusion_tpu_torch.pipeline import (
        RenderConfig,
        _tree_map,
        decode_latents,
        txt2img,
    )
    from complex_prompt_diffusion_tpu_torch.prompts import (
        ComplexPrompt,
        CompositionalPrompt,
        expand_schedule,
    )
    from complex_prompt_diffusion_tpu_torch.render import RenderEngine
    from complex_prompt_diffusion_tpu_torch.samplers.repaint import repaint_rows

    paths = {}

    # (a) the schedule grammar, parsed by the port's own parser
    bad = [(p, expand_schedule(p, 10), want) for p, want in SCHEDULE_TABLE
           if expand_schedule(p, 10) != want]
    if bad or "lark" in sys.modules:
        raise SmokeFailure(f"the schedule grammar: {bad[:3]}; lark loaded: "
                           f"{'lark' in sys.modules}")
    print(f"phase14: the schedule grammar's table, {len(SCHEDULE_TABLE)} prompts at 10 steps: "
          f"every expansion as expected, no lark loaded ({card})", flush=True)

    # (b) a 3-factor prompt at b1 with every guidance switch
    def three_factor():
        p = CompositionalPrompt("a castle on a hill at dawn", negative_prompt="blurry",
                                bundle=bundle)
        p.add_conjunction("a red dragon", scale=1.5, mask="left_half_valid")
        p.add_negation("fog", scale=0.5, mask="top_third_hidden")
        return p

    gcfg = GuidanceConfig(guidance_scale=7.5, uc_blur=True, uc_blur_k=7, uc_blur_rounds=5,
                          threshold_e="dynamic_thresholding", dynamic_scale_clip=True)
    prompt = three_factor()
    spec = prompt.build_spec(64, 64)
    if tuple(spec.masks.shape) != (3, 64, 64, 1) or spec.scales.tolist() != [1.0, 1.5, -0.5]:
        raise SmokeFailure(f"the 3-factor spec: masks {list(spec.masks.shape)}, scales "
                           f"{spec.scales.tolist()}")

    def render(label, cfg, batch, spec_):
        """The render twice: the first call (the new shapes' first launches
        and plans) and again, warm; each a path with its own counts.
        Returns the first's launch counts."""
        out = []
        for run in ("first call", "again, warm"):
            reset_launches()
            torch.cuda.reset_peak_memory_stats(bundle.device)
            torch.cuda.synchronize()
            with ModelCalls("unet_apply") as unet:
                t0 = time.perf_counter()
                _, latents = txt2img(bundle, spec_, cfg=cfg, decode=False)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                images = decode_latents(bundle, latents)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
            launches = read_launches()
            check_latents(latents, (batch, 64, 64, 4))
            check_image(images, (batch, 512, 512, 3))
            ub = (1 + spec_.num_factors) * batch
            if unet.n != cfg.steps:
                raise SmokeFailure(f"{label} made {unet.n} UNet calls, want {cfg.steps}")
            check_unet_path(launches, bundle.unet_cfg, ub, unet.n, 1, 0, label, batch)
            out.append(launches)
            peak = torch.cuda.max_memory_allocated(bundle.device) / 2**30
            print(f"phase14: {label} ({run}) on {card}: UNet batch {ub}, {unet.n} UNet calls, "
                  f"sampling {t1 - t0:.3f} s = {(t1 - t0) / cfg.steps:.4f} s/step, render with "
                  f"bf16 decode {t2 - t0:.3f} s wall, peak memory {peak:.2f} GiB; K1 sm90 "
                  f"{launches['attention_sm90']}, K2 {launches['geglu_ff']}, K3 "
                  f"{launches['group_norm']} kernels for {launches['group_norm calls']} calls, K4 "
                  f"{launches['conv3x3']} ({launches['conv3x3_sm90']} sm90); latents std "
                  f"{float(latents.std()):.4f}", flush=True)
        return out[0]

    cfg = RenderConfig(steps=PROMPT_STEPS, sampler="DDIM", width=512, height=512, batch_size=1,
                       seed=3, clip_sample="dynamic_thresholding", guidance=gcfg)
    paths["prompt_3factor_b1"] = render(
        f"3-factor CompositionalPrompt txt2img 512x512 b1 DDIM {PROMPT_STEPS}, uc blur k 7 x 5 "
        f"rounds, dynamic thresholding of eps, dynamic scale clip, clip_sample", cfg, 1, spec)

    # one guided eps of the same prompt (masks at a 16x16 latent), CUDA
    # kernels against the CPU plain twins on copies of the same weights
    cpu = torch.device("cpu")
    spec16 = prompt.build_spec(16, 16)
    spec16_cpu = GuidanceSpec(*(getattr(spec16, f).to(cpu) for f in
                                ("uncond", "factors", "scales", "masks")))
    g = torch.Generator(device=cpu).manual_seed(23)
    x = torch.randn((1, 16, 16, 4), generator=g)
    params_cpu = _tree_map(lambda a: a.to(cpu), bundle.unet_params)

    def unet_on(params):
        return lambda x_, t_, ctx: M.unet_apply(bundle.unet_cfg, params, x_, t_, ctx)

    reset_launches()
    with torch.inference_mode():
        got = cfg_epsilon(unet_on(bundle.unet_params), x.to(bundle.device), 801, spec16, 7.5,
                          gcfg=gcfg, uc_blur_on=True).cpu()
        n = read_launches()
        want = cfg_epsilon(unet_on(params_cpu), x, 801, spec16_cpu, 7.5, gcfg=gcfg,
                           uc_blur_on=True)
    del params_cpu
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    max_rel = rel_err(got, want)[1]
    print(f"phase14: one guided eps of the 3-factor spec (16x16 latent, UNet batch 4, every "
          f"switch on, blur on), CUDA kernels vs CPU plain twins: rel L2 {rel:.3e}, max abs / "
          f"max {max_rel:.3e} (tol 2e-2, bf16); K1 sm90 {n['attention_sm90']}, K4 "
          f"{n['conv3x3']} ({n['conv3x3_sm90']} sm90), K2 {n['geglu_ff']} ({card})", flush=True)
    check_unet_path(n, bundle.unet_cfg, 4, 1, 0, 0, "the 16x16 guided eps", latent=16)
    if not rel <= TOL["bfloat16"]:
        raise SmokeFailure(f"the guided eps's kernel path disagrees with the plain path: {rel:.3e}")

    # (c) the same spec at b4: UNet batch 16
    cfg4 = dataclasses.replace(cfg, steps=PROMPT_B4_STEPS, batch_size=4)
    paths["prompt_3factor_b4"] = render(
        f"3-factor CompositionalPrompt txt2img 512x512 b4 DDIM {PROMPT_B4_STEPS}, the same "
        f"switches", cfg4, 4, spec)
    if paths["prompt_3factor_b4"]["conv3x3"]:
        raise SmokeFailure("UNet batch 16 ran K4: its gate admits batch <= 4 only")
    torch.cuda.empty_cache()

    # (d) the manager's JSON API
    mgr = DiffusionModelManager(bundle=bundle)
    config = {"sampler": {"name": "DPM++ 2m"},
              "prompt_json": {"class": "WeightedPrompt", "prompt": "a cat:2.0 a dog:1.0"},
              "render": {"steps": 20, "W": 512, "H": 512, "scheduler": "karras", "seed": 4,
                         "score_corrector": "dynamic_thresholding"}}
    reset_launches()
    torch.cuda.synchronize()
    with ModelCalls("unet_apply") as unet, ModelCalls("clip_text_apply") as clip:
        t0 = time.perf_counter()
        images = mgr.process_txt2img(config)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    launches = read_launches()
    check_image(images, (1, 512, 512, 3))
    if unet.n != 20 or sorted(clip.batches) != [1, 2]:
        raise SmokeFailure(f"process_txt2img made {unet.n} UNet calls and CLIP calls of batch "
                           f"{clip.batches}: want 20, and [2, 1] (the subprompts in one batch)")
    check_unet_path(launches, bundle.unet_cfg, 2, unet.n, 1, 0, "the manager's txt2img")
    paths["manager_txt2img_weighted_dpmpp2m"] = launches
    print(f"phase14: manager process_txt2img of a WeightedPrompt JSON ('a cat:2.0 a dog:1.0') "
          f"512x512 b1 DPM++ 2M Karras 20, score corrector -> dynamic thresholding of eps, on "
          f"{card}: {t1 - t0:.3f} s wall = {(t1 - t0) / 20:.4f} s/step with the bf16 decode; "
          f"CLIP calls of batch {clip.batches}; {unet.n} UNet calls at UNet batch 2", flush=True)

    mask = np.ones((512, 512), np.float32)
    mask[100:412, 150:470] = 0.0  # repaint this block; its edges off the 8-pixel grid
    config = {"sampler": {"name": "DDIM"}, "prompt": "a stone bridge over a river",
              "jump_length": 5, "jump_n_sample": 2,
              "render": {"steps": 10, "W": 512, "H": 512, "seed": 5}}
    rows = repaint_rows(bundle.tables, 10, 5, 2)
    want_calls = int(rows["reverse"].sum())
    reset_launches()
    torch.cuda.synchronize()
    with ModelCalls("unet_apply") as unet:
        t0 = time.perf_counter()
        images = mgr.process_img2img(image, config, mask=mask)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    launches = read_launches()
    check_image(images, (1, 512, 512, 3))
    if unet.n != want_calls:
        raise SmokeFailure(f"RePaint made {unet.n} UNet calls, its jump walk has {want_calls} "
                           f"reverse transitions of {len(rows['t'])}")
    check_unet_path(launches, bundle.unet_cfg, 2, unet.n, 1, 1, "the manager's RePaint")
    paths["manager_img2img_repaint"] = launches
    print(f"phase14: manager process_img2img with a mask (RePaint, steps 10, jump_length 5, "
          f"jump_n_sample 2: {len(rows['t'])} transitions, {want_calls} reverse) of a phase-2 "
          f"image 512x512 b1, bf16 encode and decode, on {card}: {t1 - t0:.3f} s wall; "
          f"{unet.n} UNet calls at UNet batch 2 = {(t1 - t0) / unet.n:.4f} s a call", flush=True)

    # (e) the render engine along a prompt lerp
    def lerp_prompt():
        p = ComplexPrompt("a red cube on a wooden table", "blurry", bundle=bundle)
        return p.add_prompt_lerp("a blue sphere on a wooden table", magnitude=0.9,
                                 lerp_keys=["magnitude"])

    rcfg = RenderConfig(steps=RENDER_STEPS, sampler="DDIM", width=512, height=512, seed=6)
    for label, frames_n, kw, calls_want in (
            ("independent", 3, {}, 3 * RENDER_STEPS),
            ("feedback", 2, dict(feedback=True),
             RENDER_STEPS + max(1, int((1 - rcfg.denoising_strength) * RENDER_STEPS)))):
        reset_launches()
        torch.cuda.synchronize()
        with ModelCalls("unet_apply") as unet:
            t0 = time.perf_counter()
            frames = RenderEngine(bundle, rcfg).render_path(lerp_prompt(), frames_n, **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        launches = read_launches()
        if len(frames) != frames_n or unet.n != calls_want:
            raise SmokeFailure(f"render_path ({label}) gave {len(frames)} frames with {unet.n} "
                               f"UNet calls: want {frames_n} and {calls_want}")
        for f in frames:
            check_image(f[None], (1, 512, 512, 3))
        check_unet_path(launches, bundle.unet_cfg, 2, unet.n, frames_n, 0,
                        f"render_path ({label})")
        paths[f"render_path_{label}"] = launches
        print(f"phase14: RenderEngine.render_path ({label}) of a ComplexPrompt with a prompt "
              f"lerp (lerp_keys ['magnitude']): {frames_n} frames 512x512 b1 DDIM "
              f"{RENDER_STEPS}, bf16 decode, on {card}: {t1 - t0:.3f} s wall = "
              f"{(t1 - t0) / frames_n:.3f} s a frame; {unet.n} UNet calls = "
              f"{(t1 - t0) / unet.n:.4f} s a call with the decodes", flush=True)
    return paths


CONCAT_STEPS = 50  # DDIM steps of phase 15's b1 inpaint and depth2img renders (and b4 depth2img)
CONCAT_K_STEPS = 20  # DPM++ 2M Karras steps of its b4 inpaint render
CONCAT_SHORT_STEPS = 20  # DDIM steps of its manager request and 2-factor prompt
TOKENIZER_CORPUS = 2000  # strings of tools/synth_vocab.py's corpus in the native tokenizer's check


def synth_bundle(dev, unet_cfg, vae_cfg, clip_cfg, clip_layout: str, load):
    """Random trees of the three configs from seed 0, made on the card,
    written as a CompVis fp16 checkpoint (``tools/synth_checkpoint.py``) in
    a temporary directory (deleted after), loaded by ``load(path)`` and held
    bit for bit to what was written (cast as the file and the load cast it:
    fp16, then the UNet to its compute dtype, the rest to f32). Returns the
    bundle and a line of what it took."""
    import os
    import shutil

    import torch

    from complex_prompt_diffusion_tpu_torch import convert
    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch.pipeline import _tree_map, _unzero_kernels
    from complex_prompt_diffusion_tpu_torch.tools import synth_checkpoint as SC

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    unet = _unzero_kernels(gen, M.init_unet(gen, unet_cfg, dev))
    vae = M.init_vae(gen, vae_cfg, dev)
    clip = M.init_clip_text(gen, clip_cfg, dev)
    sd = SC.state_dict(unet_cfg, unet, vae, clip, clip_layout=clip_layout, dtype=torch.float16)
    n_tensors = len(sd)
    tmp = scratch_dir(2 * sum(t.numel() * t.element_size() for t in sd.values()))
    try:
        path = os.path.join(tmp, "model.ckpt")
        t1 = time.perf_counter()
        nbytes = SC.write_checkpoint(path, sd)
        del sd
        t2 = time.perf_counter()
        bundle = load(path)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def half(tree):
        return _tree_map(lambda a: a.half(), tree)

    bad = (tree_mismatches(bundle.unet_params, convert.to_port(
        half(unet), dev, bundle.unet_cfg.compute_dtype))
        + tree_mismatches(bundle.vae_params, convert.vae_params(half(vae), dev, torch.float32))
        + tree_mismatches(bundle.clip_params, convert.to_port(half(clip), dev, torch.float32)))
    del unet, vae, clip
    torch.cuda.empty_cache()
    if bad:
        raise SmokeFailure(f"the loaded checkpoint differs from what was written at {bad[:5]} "
                           f"({len(bad)} leaves)")
    return bundle, (f"{nbytes} bytes, {n_tensors} tensors, built and converted in "
                    f"{t1 - t0:.2f} s, written in {t2 - t1:.2f} s, loaded in {t3 - t2:.2f} s, "
                    f"every tree equal to the written one after the same casts")


def phase15(dev, card: str, image) -> dict:
    """Concat-conditioned UNets at full width, 512x512, and the native
    tokenizer: (a) a 9-channel SD-1.5 inpaint checkpoint (fp16, random
    weights) loaded by ``ModelBundle.from_checkpoint`` (UNet bf16, bf16 VAE):
    ``inpaint`` b1 DDIM 50 and b4 DPM++ 2M Karras 20, the manager's JSON
    request with a mask (its 9-channel branch), a 2-factor composed prompt
    (UNet batch 3); (b) a 5-channel SD-2 depth checkpoint loaded by
    ``config.bundle_from_config`` with v2-midas-inference's model section:
    ``depth2img`` (Sobel depth) b1 strength 0.75 DDIM 50 with the bf16
    VAE, and b4 with the exact-f32 one; (c) the native tokenizer built by
    the host compiler, its ids against the Python BPE tokenizer's. Every
    render's K1-K4 launches are ``unet_call_launches``' of the loaded config
    times its UNet calls. Returns the launch counts by path."""
    import numpy as np
    import torch

    from complex_prompt_diffusion_tpu_torch import config as CONF
    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch import schedules as S
    from complex_prompt_diffusion_tpu_torch.guidance.cfg import GuidanceSpec, cfg_epsilon
    from complex_prompt_diffusion_tpu_torch.manager import DiffusionModelManager
    from complex_prompt_diffusion_tpu_torch.pipeline import (
        ModelBundle,
        RenderConfig,
        _tree_map,
        depth2img,
        img2img_t_enc,
        inpaint,
        make_guidance_spec,
    )
    from complex_prompt_diffusion_tpu_torch.prompts import CompositionalPrompt

    paths = {}

    def render(bundle, label, fn, ub, calls, batch, decode_dtype="bfloat16", encode_batch=1):
        """One render (``fn`` returns images and latents, or images only):
        its UNet calls at UNet batch ``ub``, one encode at ``encode_batch``
        and one decode at ``batch``, every K1-K4 launch as predicted."""
        reset_launches()
        torch.cuda.synchronize()
        with ModelCalls("unet_apply") as unet:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        launches = read_launches()
        images, latents = out if isinstance(out, tuple) else (out, None)
        check_image(images, (batch, 512, 512, 3))
        if latents is not None:
            check_latents(latents, (batch, 64, 64, 4))
        if unet.n != calls or set(unet.batches) != {ub}:
            raise SmokeFailure(f"{label} made {unet.n} UNet calls at UNet batches "
                               f"{sorted(set(unet.batches))}: want {calls} at {ub}")
        check_unet_path(launches, bundle.unet_cfg, ub, unet.n, 1, 1, label, batch,
                        decode_dtype=decode_dtype, encode_batch=encode_batch)
        std = f"; latents std {float(latents.std()):.4f}" if latents is not None else ""
        print(f"phase15: {label} on {card}: {t1 - t0:.3f} s wall with the prompt encode, the "
              f"VAE encode and decode = {(t1 - t0) / calls:.4f} s a step; UNet batch {ub}, "
              f"{unet.n} calls; K1 sm90 {launches['attention_sm90']}, K2 "
              f"{launches['geglu_ff']}, K3 {launches['group_norm']} kernels for "
              f"{launches['group_norm calls']} calls, K4 {launches['conv3x3']} "
              f"({launches['conv3x3_sm90']} sm90){std}", flush=True)
        return launches

    def concat_eps(bundle, cond, label, seed):
        """One guided eps (CFG 7.5) of a plain prompt on a 16x16 latent
        (UNet batch 2; K1 at S = 256, every 16^2-plane conv, conv_in's C =
        9 or 5 among them, inside K4's gate) with the concat channels
        ``cond`` (CPU f32), CUDA kernels against the CPU plain twins on
        copies of the same weights: in bf16, the UNet's output (both
        branches) at phases 3 and 13's bf16 UNet tolerance, 5e-2; with the
        UNet cast to f32 (TF32 off; conv_in and the out conv on K4's
        narrow bodies, the other convs on its 3xTF32 body), the guided
        eps at 1e-4. The bf16 guided eps is printed, not held: CFG 7.5
        multiplies the two branches' difference, a small part of an eps on
        these random weights (printed), and with it their bf16 rounding,
        so its error is several times a branch's."""
        cpu = torch.device("cpu")
        spec = make_guidance_spec(bundle, "a red door", "blurry")
        spec_cpu = GuidanceSpec(*(getattr(spec, f).to(cpu) for f in
                                  ("uncond", "factors", "scales", "masks")))
        x = torch.randn((1, 16, 16, 4), generator=torch.Generator().manual_seed(seed))
        errs, launches = {}, {}
        for dt in ("bfloat16", "float32"):
            b = bundle if dt == "bfloat16" else bundle.cast("float32")
            params_cpu = _tree_map(lambda a: a.to(cpu), b.unet_params)
            raw = {}

            def unet_on(params, key, b=b, raw=raw):
                def eps(x_, t_, ctx):
                    raw[key] = M.unet_apply(b.unet_cfg, params, x_, t_, ctx)
                    return raw[key]
                return eps

            reset_launches()
            with torch.inference_mode():
                got = cfg_epsilon(unet_on(b.unet_params, "got"), x.to(dev), 801, spec, 7.5,
                                  depth_mask=cond.to(dev)).cpu()
                launches[dt] = read_launches()
                want = cfg_epsilon(unet_on(params_cpu, "want"), x, 801, spec_cpu, 7.5,
                                   depth_mask=cond)
            errs[dt] = (float((raw["got"].cpu().float() - raw["want"].float()).norm()
                              / raw["want"].float().norm()),
                        float((got.float() - want.float()).norm() / want.float().norm()))
            e_u, e_c = raw["want"].float()
            spread = float((e_c - e_u).norm() / e_u.norm())
            del b, params_cpu, raw
            torch.cuda.empty_cache()
        n, n32 = launches["bfloat16"], launches["float32"]
        print(f"phase15: one guided eps (CFG 7.5) of the {label} (16x16 latent, UNet batch 2, "
              f"{bundle.unet_cfg.in_channels} input channels), CUDA kernels vs CPU plain twins: "
              f"bf16 UNet output rel L2 {errs['bfloat16'][0]:.3e} (tol 5e-2), guided eps "
              f"{errs['bfloat16'][1]:.3e} (not held; |e_c - e_u| / |e_u| {spread:.3e}); f32 UNet output {errs['float32'][0]:.3e}, "
              f"guided eps {errs['float32'][1]:.3e} (tol 1e-4, TF32 off); bf16: K1 sm90 "
              f"{n['attention_sm90']}, K4 {n['conv3x3']} ({n['conv3x3_sm90']} sm90), K2 "
              f"{n['geglu_ff']}; f32: K4 {n32['conv3x3']} ({n32['conv3x3_f32_sm90']} 3xTF32), "
              f"K1 fused f32 {n32['attention_f32_fused_sm90']} ({card})", flush=True)
        check_unet_path(n, bundle.unet_cfg, 2, 1, 0, 0, f"the 16x16 guided eps of the {label}",
                        latent=16)
        k4 = unet_call_launches(bundle.unet_cfg, 16, 2, "float32")["k4"]
        if (n32["conv3x3"] != k4 or n32["conv3x3_f32_sm90"] != k4 - 2 or n32["conv3x3_sm90"]
                or n32["attention_sm90"]):
            raise SmokeFailure(f"the f32 16x16 guided eps of the {label} launched {n32}: want K4 "
                               f"{k4} times, all but conv_in and the out conv on its 3xTF32 "
                               f"body, no bf16 body")
        if not (errs["bfloat16"][0] <= 5e-2 and errs["float32"][1] <= 1e-4):
            raise SmokeFailure(f"the {label}'s kernel path disagrees with the plain path: {errs}")
        return n

    mask = np.zeros((512, 512), np.float32)
    mask[100:412, 150:470] = 1.0  # the hole; its edges off the 8-pixel grid
    ddim50 = S.make_inference_tables(S.make_diffusion_tables(), CONCAT_STEPS).num_steps
    ddim20 = S.make_inference_tables(S.make_diffusion_tables(), CONCAT_SHORT_STEPS).num_steps

    # (a) SD-1.5 inpaint: 4 latent + mask + 4 masked-image channels
    want_cfg = dataclasses.replace(M.UNetConfig.sd_inpaint(), dtype="bfloat16")
    bundle, took = synth_bundle(
        dev, M.UNetConfig.sd_inpaint(), M.VAEConfig.sd(), M.CLIPTextConfig.sd15(), "hf",
        lambda path: ModelBundle.from_checkpoint(path, dtype="bfloat16", device=dev))
    if bundle.unet_cfg != want_cfg or bundle.version != "sd1":
        raise SmokeFailure(f"the 9-channel checkpoint loaded as {bundle.version} "
                           f"{bundle.unet_cfg}: want sd1 {want_cfg}")
    print(f"phase15: SD-1.5 inpaint checkpoint (9-channel UNet, CompVis layout, fp16, random "
          f"weights from seed 0): {took} through ModelBundle.from_checkpoint (UNet bf16); "
          f"config UNetConfig.sd_inpaint ({card})", flush=True)
    g = torch.Generator().manual_seed(29)
    hole = (torch.rand((1, 16, 16, 1), generator=g) > 0.5).float()
    paths["inpaint_unet_eval_16"] = concat_eps(
        bundle, torch.cat([hole, torch.randn((1, 16, 16, 4), generator=g)], -1),
        "9-channel inpaint UNet ([mask, masked latents] concat)", 31)
    bundle16 = bundle.cast_vae("bfloat16")
    prompt = "a wooden door in a stone wall"
    cfg = RenderConfig(steps=CONCAT_STEPS, sampler="DDIM", eta=0.0, guidance_scale=7.5,
                       width=512, height=512, seed=7)
    paths["inpaint_b1_ddim"] = render(
        bundle16, f"inpaint 512x512 b1 DDIM {CONCAT_STEPS} CFG 7.5, bf16 VAE",
        lambda: inpaint(bundle16, image, mask, prompt, "blurry", cfg), 2, ddim50, 1)
    cfg4 = RenderConfig(steps=CONCAT_K_STEPS, sampler="DPM++ 2m", sigma_schedule="karras",
                        guidance_scale=7.5, width=512, height=512, batch_size=4, seed=8)
    paths["inpaint_b4_dpmpp2m"] = render(
        bundle16, f"inpaint 512x512 b4 DPM++ 2M Karras {CONCAT_K_STEPS} CFG 7.5, bf16 VAE",
        lambda: inpaint(bundle16, image, mask, prompt, "blurry", cfg4), 8, CONCAT_K_STEPS, 4)
    mgr = DiffusionModelManager(bundle=bundle16)
    config = {"sampler": {"name": "DDIM"}, "prompt": prompt, "negative_prompt": "blurry",
              "render": {"steps": CONCAT_SHORT_STEPS, "W": 512, "H": 512, "seed": 9}}
    paths["manager_inpaint_model"] = render(
        bundle16, f"manager process_img2img with a mask on the 9-channel UNet (its inpaint "
        f"branch) 512x512 b1 DDIM {CONCAT_SHORT_STEPS}",
        lambda: mgr.process_img2img(image, config, mask=mask), 2, ddim20, 1)
    composed = CompositionalPrompt("a stone cottage", negative_prompt="blurry", bundle=bundle16)
    composed.add_conjunction("ivy on the walls", scale=1.5, mask="left_half_valid")
    spec = composed.build_spec(64, 64)
    cfg2 = dataclasses.replace(cfg, steps=CONCAT_SHORT_STEPS, seed=10)
    paths["inpaint_2factor_b1"] = render(
        bundle16, f"inpaint of a 2-factor CompositionalPrompt 512x512 b1 DDIM "
        f"{CONCAT_SHORT_STEPS}", lambda: inpaint(bundle16, image, mask, spec, cfg=cfg2),
        1 + spec.num_factors, ddim20, 1)
    del bundle, bundle16, mgr, composed, spec
    torch.cuda.empty_cache()

    # (b) SD-2 depth: 4 latent + the depth channel
    want_cfg = dataclasses.replace(M.UNetConfig.sd2_depth(), dtype="bfloat16")
    bundle, took = synth_bundle(
        dev, M.UNetConfig.sd2_depth(), M.VAEConfig.sd(), M.CLIPTextConfig.sd21(), "openclip",
        lambda path: CONF.bundle_from_config(V2_MIDAS_MODEL, checkpoint_path=path,
                                             dtype="bfloat16", device=dev))
    fields = (bundle.version, bundle.parameterization, bundle.clip_layer, bundle.unet_cfg)
    if fields != ("sd2", "eps", "penultimate", want_cfg):
        raise SmokeFailure(f"the 5-channel checkpoint loaded as {fields}: want sd2, eps, "
                           f"penultimate, {want_cfg}")
    print(f"phase15: SD-2 depth checkpoint (5-channel UNet, CompVis layout, fp16, random "
          f"weights from seed 0): {took} through config.bundle_from_config "
          f"(v2-midas-inference's model section; UNet bf16); config UNetConfig.sd2_depth, eps "
          f"({card})", flush=True)
    depth = torch.rand((16, 16, 1), generator=torch.Generator().manual_seed(37)) * 2 - 1
    paths["depth_unet_eval_16"] = concat_eps(bundle, depth, "5-channel depth UNet ([h, w, 1] "
                                             "depth channel, broadcast over the batch)", 41)
    prompt = "a lighthouse on a cliff, oil painting"
    cfg = RenderConfig(steps=CONCAT_STEPS, sampler="DDIM", eta=0.0, guidance_scale=7.5,
                       width=512, height=512, seed=11, denoising_strength=0.75)
    t_enc = img2img_t_enc(cfg.denoising_strength, ddim50, "t")
    bundle16 = bundle.cast_vae("bfloat16")
    paths["depth2img_b1_ddim"] = render(
        bundle16, f"depth2img (Sobel depth) 512x512 b1 strength 0.75 DDIM {CONCAT_STEPS} "
        f"({t_enc} steps run) CFG 7.5, bf16 VAE",
        lambda: depth2img(bundle16, image, prompt, "blurry", cfg), 2, t_enc, 1)
    del bundle16
    torch.cuda.empty_cache()
    images4 = np.ascontiguousarray(np.stack([image, image[:, ::-1], image[::-1],
                                             np.rot90(image)]))
    paths["depth2img_b4_f32_vae"] = render(
        bundle, f"depth2img (Sobel depth, one map an image) 512x512 b4 strength 0.75 DDIM "
        f"{CONCAT_STEPS} ({t_enc} steps run) CFG 7.5, exact-f32 VAE (TF32 off)",
        lambda: depth2img(bundle, images4, prompt, "blurry", dataclasses.replace(cfg, seed=12)),
        8, t_enc, 4, decode_dtype="float32", encode_batch=4)
    del bundle
    torch.cuda.empty_cache()

    # (c) the native tokenizer, built here by the host compiler
    import shutil
    import tempfile

    from complex_prompt_diffusion_tpu_torch.prompts import tokenizer_native as TN
    from complex_prompt_diffusion_tpu_torch.prompts.tokenizer import ClipBPETokenizer
    from complex_prompt_diffusion_tpu_torch.tools import synth_vocab as SV

    tmp = tempfile.mkdtemp(prefix="vocab-")
    try:
        py = ClipBPETokenizer(*SV.write_synthetic_vocab(tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    lib = TN.load_library()
    t1 = time.perf_counter()
    native = TN.NativeClipTokenizer(py)
    corpus = SV.corpus(TOKENIZER_CORPUS, seed=0, most=24)
    t2 = time.perf_counter()
    got = [native.encode_text(t) for t in corpus]
    t3 = time.perf_counter()
    py.cache.clear()
    want = [py.encode_text(t) for t in corpus]
    t4 = time.perf_counter()
    bad = [t for t, a, b in zip(corpus, got, want) if a != b]
    seq_ok = np.array_equal(native(corpus[:64]), py(corpus[:64]))
    if bad or not seq_ok or "native" in Path(lib._name).parts:
        raise SmokeFailure(f"the native tokenizer ({lib._name}) differs from the Python BPE on "
                           f"{len(bad)} of {len(corpus)} strings ({bad[:3]}), sequences equal: "
                           f"{seq_ok}")
    print(f"phase15: native tokenizer built by the host compiler and loaded in {t1 - t0:.2f} s "
          f"({Path(lib._name).name}); ids equal to the Python BPE tokenizer's on all "
          f"{len(corpus)} strings of a fixed corpus (synthetic byte-level vocab), the 77-token "
          f"sequences of 64 of them equal; encode {1e6 * (t3 - t2) / len(corpus):.1f} us a "
          f"string native, {1e6 * (t4 - t3) / len(corpus):.1f} us Python (cache cleared; "
          f"host, {card})", flush=True)
    return paths


PROMPT16 = "a photograph of an astronaut riding a horse"  # phase 2's prompt
DC_STEPS = 50  # DDIM steps of phase 16's b4 DeepCache and ToDo renders
DC_K_STEPS = 20  # DPM++ 2M Karras steps of its b4 DeepCache render
TOME_STEPS = (50, 20)  # DDIM steps of its b1 ToMe renders, ratio 0.75 and 0.3
GUIDE_STEPS = 50  # DDIM steps of its attention-guided render
TILE_STEPS = 20  # DDIM steps of its tiled renders
SD15_DEEP_AT = 9  # SD-1.5's default DeepCache split (models.unet.deepcache_default_block)


class UNetCallKinds:
    """Records every UNet call while the block runs, through the models
    package and inside ``models/unet.py`` (where DeepCache's pair calls
    it): its batch and kind, "full" or "shallow"."""

    def __enter__(self):
        from complex_prompt_diffusion_tpu_torch import models as M
        from complex_prompt_diffusion_tpu_torch.models import unet as U

        self.calls, self._mods, self._inner = [], (M, U), U.unet_apply

        def counted(cfg, params, x, *args, **kwargs):
            kind = "shallow" if kwargs.get("deep_feature") is not None else "full"
            self.calls.append((int(x.shape[0]), kind))
            return self._inner(cfg, params, x, *args, **kwargs)

        for mod in self._mods:
            mod.unet_apply = counted
        return self

    def __exit__(self, *exc):
        for mod in self._mods:
            mod.unet_apply = self._inner


def check_held(cfg, latent: int, ub: int, deep_at, what: str, model: int = 1) -> None:
    """Phase 1 held every K1-K4 shape of this UNet call to its plain twin
    (``kernel_cases.held_unet_shapes``, from ``unet_call_groups``): a
    full-width call (latent >= 64) at a shape no group has fails here. The
    small evals (16^2 and 24^2 latents) are held whole against the CPU twins
    where they run."""
    from complex_prompt_diffusion_tpu_torch.tools.kernel_cases import (
        held_unet_shapes,
        unet_shape_keys,
    )

    if latent < 64:
        return
    missing = unet_shape_keys(cfg, latent, ub, deep_at, model) - held_unet_shapes()
    if missing:
        raise SmokeFailure(f"{what}: phase 1 holds no case at its UNet calls' shapes "
                           f"{sorted(missing)} (UNet batch {ub}, latent {latent}): add the call "
                           f"to kernel_cases.unet_call_groups")


def check_calls(launches: dict, what: str, calls, decodes: int = 0, batch: int = 1,
                s_decode: int = 4096, f32_decodes: int = 0) -> None:
    """A bf16 path's K1-K4 launches against its UNet calls: ``calls`` lists
    (n, config, latent side, UNet batch, deep_at) groups, each call's counts
    from ``unet_call_launches`` (a shallow pass with ``deep_at``; token
    reduction as the config sets it); K3's calls for them, ``decodes`` bf16
    decodes (at ``batch``, the mid-block at ``s_decode`` tokens on K1's
    wide body) and ``f32_decodes`` f32 ones (the mid-block's passes on K1's
    3xTF32 body); nothing on the other f32 bodies, K5 or the probes."""
    from complex_prompt_diffusion_tpu_torch.ops.attention import f32_sm90_launches

    want = {"attention_sm90": 0, "geglu_ff": 0, "conv3x3": 0, "conv3x3_sm90": 0,
            "conv3x3_narrow": 0,
            "attention_f32_sm90": f32_decodes * f32_sm90_launches(batch, 1, s_decode, s_decode)}
    gn = 0
    cat = (0, 0, 0)
    for n, cfg, latent, ub, deep_at in calls:
        check_held(cfg, latent, ub, deep_at, what)
        per = unet_call_launches(cfg, latent, ub, deep_at=deep_at)
        for key, k in (("attention_sm90", "k1"), ("geglu_ff", "k2"), ("conv3x3", "k4"),
                       ("conv3x3_sm90", "k4_sm90"), ("conv3x3_narrow", "k4_narrow")):
            want[key] += n * per[k]
        gn += n * per["k3"]
        cat = tuple(a + b for a, b in zip(cat, cat_counts(per, n)))
    got = {k: launches[k] for k in want}
    if got != want:
        raise SmokeFailure(f"{what} launched {got}: want {want} from its UNet calls {calls}")
    check_cat(launches, cat, what)
    want_gn = gn + VAE_DECODE_GN_CALLS * (decodes + f32_decodes)
    if (launches["group_norm calls"] != want_gn
            or launches["group_norm"] != launches["group_norm planned"]
            or launches["group_norm_prior"]):
        raise SmokeFailure(f"K3 in {what}: {launches['group_norm calls']} calls (want {want_gn}), "
                           f"{launches['group_norm']} kernels against "
                           f"{launches['group_norm planned']} planned, the replaced body "
                           f"{launches['group_norm_prior']}")
    check_wide(launches, decodes, batch, what, s=s_decode)
    others = {n: launches[n] for n in ("attention_f32_fused_sm90", "conv3x3_f32_sm90",
                                       "geglu_ff_f32_sm90", "attention_cm")
              + PROBES if launches[n]}
    if others:
        raise SmokeFailure(f"{what} launched kernels off its path: {others}")


def rel_rmse(got, want) -> float:
    return float((got.float() - want.float()).pow(2).mean().sqrt()
                 / want.float().pow(2).mean().sqrt())


def phase16(dev, card: str) -> dict:
    """The UNet's opt-in modes at SD-1.5 full width (phase 2's bundle
    rebuilt from seed 0: bf16 UNet, bf16 VAE; 512x512 unless said): (a) the
    skip, feature and attention-map interfaces (the inject identity, DAAM);
    (b) DeepCache, its shallow pass against the full one; (c) ToDo and ToMe
    token reduction, the merged attention and FF against their plain twins
    under one plan; (d) attention-saliency guidance, one guided eps in f32
    against the CPU twins; (e) tiled inference at 1024x1024, and a single
    tile at 512x512 against the untiled render. Every render's K1-K4
    launches follow from its UNet calls by kind (``check_calls``). Returns
    the launch counts by path."""
    import collections
    import dataclasses

    import numpy as np
    import torch

    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch import schedules as S
    from complex_prompt_diffusion_tpu_torch.guidance import (
        GuidanceConfig,
        GuidanceSpec,
        cfg_epsilon,
        cfg_epsilon_attn_guided,
    )
    from complex_prompt_diffusion_tpu_torch.guidance.daam import word_heat_map
    from complex_prompt_diffusion_tpu_torch.models import layers as L
    from complex_prompt_diffusion_tpu_torch.models.tiled import tile_positions
    from complex_prompt_diffusion_tpu_torch.ops import tome as TM
    from complex_prompt_diffusion_tpu_torch.ops.attention import attention_plain, flash_attention
    from complex_prompt_diffusion_tpu_torch.ops.mlp import geglu_ff, geglu_ff_plain
    from complex_prompt_diffusion_tpu_torch.pipeline import (
        ModelBundle,
        RenderConfig,
        _tree_map,
        decode_latents,
        make_guidance_spec,
        txt2img,
    )
    from complex_prompt_diffusion_tpu_torch.utils.metrics import psnr, ssim

    paths = {}
    t0 = time.perf_counter()
    bundle = ModelBundle.random("sd15", seed=0, device=dev).cast_vae("bfloat16")
    torch.cuda.synchronize()
    ucfg, params = bundle.unet_cfg, bundle.unet_params
    print(f"phase16: SD-1.5 random bundle of phase 2 (seed 0; UNet bf16, VAE cast to bf16) "
          f"rebuilt in {time.perf_counter() - t0:.2f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(16)

    # (a) the interfaces: a UNet-batch-8 call returning its skips, decoder
    # features and the feature entering output block 0, then the same call
    # with all of them injected back
    x = torch.randn((8, 64, 64, 4), generator=gen, device=dev)
    t = torch.full((8,), 601, dtype=torch.long, device=dev)
    ctx = torch.randn((8, 77, 768), generator=gen, device=dev)
    reset_launches()
    with torch.inference_mode():
        out, skips, feats, deep0 = M.unet_apply(ucfg, params, x, t, ctx, return_skips=True,
                                                return_feats=True, return_deep_at=0)
        again = M.unet_apply(ucfg, params, x, t, ctx, inject_skips=skips, inject_skips_stop=99,
                             inject_feats=(deep0,) + feats[:-1], inject_feats_stop=99)
        torch.cuda.synchronize()
    launches = read_launches()
    check_calls(launches, "the inject identity", [(2, ucfg, 64, 8, None)])
    same = torch.equal(again, out)
    print(f"phase16: (a) UNet batch 8, return_skips + return_feats + return_deep_at=0: "
          f"{len(skips)} skips, {len(feats)} features; injected back (skips and features, stop "
          f"99): output torch.equal {same} ({card})", flush=True)
    if not same:
        raise SmokeFailure("finding: injecting a call's own skips and features changed its "
                           "output on the card: a kernel is not deterministic")
    paths["unet_inject_identity_ub8"] = launches
    reset_launches()
    with torch.inference_mode():
        out_m, maps = M.unet_apply(ucfg, params, x[:2], t[:2], ctx[:2], collect_attn_maps=True)
        plain = M.unet_apply(ucfg, params, x[:2], t[:2], ctx[:2])
        hm = word_heat_map(maps, [1, 2])
        torch.cuda.synchronize()
    launches = read_launches()
    check_calls(launches, "the attention-map call", [(2, ucfg, 64, 2, None)])
    paths["unet_attn_maps_ub2"] = launches
    worst = max(float((m.sum(-1) - 1).abs().max()) for m in maps)
    rel = float((out_m - plain).norm() / plain.norm())
    shapes = sorted({tuple(m.shape) for m in maps})
    print(f"phase16: (a) collect_attn_maps at UNet batch 2: {len(maps)} maps {shapes}, f32, rows "
          f"sum to 1 within {worst:.2e}; output vs the plain call rel L2 {rel:.3e} (tol 5e-2); "
          f"word_heat_map of tokens 1-2: {list(hm.shape)} in [{float(hm.min()):.3f}, "
          f"{float(hm.max()):.3f}] ({card})", flush=True)
    if (len(maps) != 16 or any(m.dtype != torch.float32 or m.shape[:2] != (2, 8)
                               or m.shape[3] != 77 for m in maps)
            or worst > 1e-3 or not rel <= 5e-2 or tuple(hm.shape) != (64, 64)
            or not bool(torch.isfinite(hm).all()) or float(hm.min()) < 0
            or float(hm.max()) > 1):
        raise SmokeFailure(f"the attention maps: {len(maps)} maps {shapes}, row sums off by "
                           f"{worst}, output rel {rel}, heat map {list(hm.shape)}")

    def render(label, bundle_, cfg, calls, prompt=PROMPT16, decode=True):
        """One render with its UNet calls recorded by kind and its launches
        checked against ``calls`` (as ``check_calls``); returns (latents,
        images, launches, s/step)."""
        b, side = cfg.batch_size, cfg.height // 8
        reset_launches()
        torch.cuda.synchronize()
        with UNetCallKinds() as kinds:
            t0 = time.perf_counter()
            _, latents = txt2img(bundle_, prompt, cfg=cfg, decode=False)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        images = decode_latents(bundle_, latents) if decode else None
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = read_launches()
        check_latents(latents, (b, side, side, 4))
        if decode:
            check_image(images, (b, cfg.height, cfg.width, 3))
        want_kinds = collections.Counter()
        for n, _, _, ub, deep_at in calls:
            want_kinds[(ub, "full" if deep_at is None else "shallow")] += n
        if collections.Counter(kinds.calls) != want_kinds:
            raise SmokeFailure(f"{label} made the UNet calls {collections.Counter(kinds.calls)}, "
                               f"want {dict(want_kinds)}")
        check_calls(launches, label, calls, decodes=int(decode), batch=b, s_decode=side * side)
        steps = cfg.steps
        print(f"phase16: {label} on {card}: UNet calls {dict(want_kinds)} (batch, kind); "
              f"sampling {t1 - t0:.3f} s = {(t1 - t0) / steps:.4f} s/step"
              + (f", render with bf16 decode {t2 - t0:.3f} s wall" if decode else "")
              + f"; K1 sm90 {launches['attention_sm90']}, K2 {launches['geglu_ff']}, K3 "
              f"{launches['group_norm']} kernels for {launches['group_norm calls']} calls, K4 "
              f"{launches['conv3x3']} ({launches['conv3x3_sm90']} sm90)", flush=True)
        return latents, images, launches, (t1 - t0) / steps

    def compare(label, got, ref, b):
        """relRMSE of the latents, PSNR and SSIM of the uint8 images against
        the exact render (random weights: not comparable with trained-weight
        numbers)."""
        print(f"phase16: {label} against the exact render of the same seed: latent relRMSE "
              f"{rel_rmse(got[0], ref[0]):.4e}, s/step {got[3]:.4f} against {ref[3]:.4f}"
              + (f", uint8 PSNR {psnr(got[1], ref[1]):.2f} dB, SSIM {ssim(got[1], ref[1]):.4f}"
                 if got[1] is not None else "")
              + f" (random weights; batch {b}; {card})", flush=True)

    # (b) DeepCache: the exact b4 DDIM 50 and DPM++ 2M Karras 20 renders,
    # then each with the cache (interval 3: 17 full and 33 shallow calls;
    # interval 2: 10 and 10)
    b4 = dict(width=512, height=512, batch_size=4, seed=0, guidance_scale=7.5)
    ddim50 = RenderConfig(steps=DC_STEPS, sampler="DDIM", **b4)
    dpm20 = RenderConfig(steps=DC_K_STEPS, sampler="DPM++ 2m", sigma_schedule="karras", **b4)
    ref_b4 = render(f"exact b4 DDIM {DC_STEPS}", bundle, ddim50, [(DC_STEPS, ucfg, 64, 8, None)])
    paths["exact_b4_ddim50"] = ref_b4[2]
    ref_b4k = render(f"exact b4 DPM++ 2M Karras {DC_K_STEPS}", bundle, dpm20,
                     [(DC_K_STEPS, ucfg, 64, 8, None)])
    paths["exact_b4_dpmpp2m"] = ref_b4k[2]
    full3 = len(range(0, DC_STEPS, 3))
    got = render(f"DeepCache b4 DDIM {DC_STEPS} interval 3", bundle,
                 dataclasses.replace(ddim50, deepcache_interval=3),
                 [(full3, ucfg, 64, 8, None), (DC_STEPS - full3, ucfg, 64, 8, SD15_DEEP_AT)])
    paths["deepcache3_b4_ddim50"] = got[2]
    compare(f"DeepCache b4 DDIM {DC_STEPS} interval 3", got, ref_b4, 4)
    got = render(f"DeepCache b4 DPM++ 2M Karras {DC_K_STEPS} interval 2", bundle,
                 dataclasses.replace(dpm20, deepcache_interval=2),
                 [(DC_K_STEPS // 2, ucfg, 64, 8, None),
                  (DC_K_STEPS // 2, ucfg, 64, 8, SD15_DEEP_AT)])
    paths["deepcache2_b4_dpmpp2m"] = got[2]
    compare(f"DeepCache b4 DPM++ 2M Karras {DC_K_STEPS} interval 2", got, ref_b4k, 4)
    # the shallow pass fed the same call's deep feature, through the hoisted
    # cross k/v, against the full pass: the same bits
    with torch.inference_mode():
        kv = M.precompute_cross_kv(ucfg, params, ctx)
        out_full, deep = M.unet_apply(ucfg, params, x, t, ctx, cross_kv=kv,
                                      return_deep_at=SD15_DEEP_AT)
        out_sh = M.unet_apply(ucfg, params, x, t, ctx, cross_kv=kv, deep_feature=deep,
                              deep_at=SD15_DEEP_AT)
        same = torch.equal(out_sh, out_full)
    print(f"phase16: (b) shallow pass (deep_at {SD15_DEEP_AT}, hoisted cross k/v) fed the same "
          f"call's deep feature {list(deep.shape)} vs the full pass at UNet batch 8: torch.equal "
          f"{same} ({card})", flush=True)
    if not same:
        raise SmokeFailure("finding: the shallow pass differs from the full pass on the card: a "
                           "kernel is not deterministic")

    # (c) token reduction: ToDo (K/V pooled 2x2 at level 0) at b4 DDIM 50,
    # with DeepCache 3 too; ToMe merge with tome_mlp and tome_crossattn at
    # b1, ratio 0.75 (S' = 1024) over DDIM 50 and 0.3 (S' = 2868) over 20
    todo = dataclasses.replace(ucfg, tome_ratio=0.75, tome_mode="downsample")
    got = render(f"ToDo 0.75 b4 DDIM {DC_STEPS}", bundle,
                 dataclasses.replace(ddim50, tome_ratio=0.75), [(DC_STEPS, todo, 64, 8, None)])
    paths["todo_b4_ddim50"] = got[2]
    compare(f"ToDo 0.75 b4 DDIM {DC_STEPS}", got, ref_b4, 4)
    got = render(f"DeepCache 3 + ToDo 0.75 b4 DDIM {DC_STEPS}", bundle,
                 dataclasses.replace(ddim50, tome_ratio=0.75, deepcache_interval=3),
                 [(full3, todo, 64, 8, None), (DC_STEPS - full3, todo, 64, 8, SD15_DEEP_AT)])
    paths["deepcache3_todo_b4_ddim50"] = got[2]
    compare(f"DeepCache 3 + ToDo 0.75 b4 DDIM {DC_STEPS}", got, ref_b4, 4)
    b1 = dict(width=512, height=512, batch_size=1, seed=1, guidance_scale=7.5)
    tome_bundle = dataclasses.replace(bundle, unet_cfg=dataclasses.replace(
        ucfg, tome_mlp=True, tome_crossattn=True))
    refs_b1 = {}
    for ratio, steps in zip((0.75, 0.3), TOME_STEPS):
        cfg = RenderConfig(steps=steps, sampler="DDIM", **b1)
        if steps not in refs_b1:
            refs_b1[steps] = render(f"exact b1 DDIM {steps}", bundle, cfg,
                                    [(steps, ucfg, 64, 2, None)])
            paths[f"exact_b1_ddim{steps}"] = refs_b1[steps][2]
        merge = dataclasses.replace(tome_bundle.unet_cfg, tome_ratio=ratio, tome_mode="merge")
        label = f"ToMe merge {ratio} + tome_mlp + tome_crossattn b1 DDIM {steps}"
        got = render(label, tome_bundle, dataclasses.replace(cfg, tome_ratio=ratio,
                                                             tome_mode="merge"),
                     [(steps, merge, 64, 2, None)])
        paths[f"tome{ratio}_b1_ddim{steps}"] = got[2]
        compare(label, got, refs_b1[steps], 1)
    # the merged level-0 attention and FF through K1 and K2 against their
    # plain twins under ONE plan (a plan built twice from bf16 scores may
    # break ties otherwise)
    blk = params["input_blocks"][1][1]["blocks"][0]
    xs = torch.randn((2, 4096, 320), generator=gen, device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        for ratio in (0.75, 0.3):
            r = min(int(ratio * 4096), 4096 - 1024)
            plan = TM.build_merge(xs, 64, 64, r)
            a1 = blk["attn1"]
            w = torch.cat([a1["to_q"]["kernel"], a1["to_k"]["kernel"], a1["to_v"]["kernel"]], 1)
            q, k, v = L.linear({"kernel": w}, TM.tome_merge(plan, L.layer_norm(blk["norm1"], xs))
                               ).chunk(3, dim=-1)
            reset_launches()
            got_a = TM.tome_unmerge(plan, flash_attention(q, k, v, 8))
            ff = blk["ff"]
            ff_args = (ff["proj"]["kernel"], ff["proj"]["bias"], ff["out"]["kernel"],
                       ff["out"]["bias"])
            y = TM.tome_merge(plan, L.layer_norm(blk["norm3"], xs))
            got_f = TM.tome_unmerge(plan, geglu_ff(y, *ff_args))
            torch.cuda.synchronize()
            n = read_launches()
            want_a = TM.tome_unmerge(plan, attention_plain(q, k, v, 8))
            want_f = TM.tome_unmerge(plan, geglu_ff_plain(y, *ff_args))
            ea, ef = rel_err(got_a, want_a), rel_err(got_f, want_f)
            print(f"phase16: (c) ToMe {ratio} under one plan (S' = {4096 - r}, UNet batch 2, "
                  f"level 0): K1 ({n['attention_sm90']} launch) rel {ea[1]:.3e}, K2 "
                  f"({n['geglu_ff']} kernels, M = {2 * (4096 - r)}) rel {ef[1]:.3e} against the "
                  f"plain twins, unmerged (tol {TOL['bfloat16']:.0e}) ({card})", flush=True)
            if (ea[1] > TOL["bfloat16"] or ef[1] > TOL["bfloat16"] or n["attention_sm90"] != 1
                    or n["geglu_ff"] <= 0):
                raise SmokeFailure(f"ToMe {ratio} under one plan: K1 rel {ea[1]}, K2 rel {ef[1]}, "
                                   f"launches {n}")

    # (d) attention-saliency guidance at b1 DDIM 50 (rounds 4, scale 1.1,
    # blur 31): 50 CFG calls (4 of them with the skips) and 4 calls at UNet
    # batch 1 on the unconditional context
    gcfg = GuidanceConfig(attn_guide=True, attn_guide_rounds=4, attn_guide_scale=1.1,
                          attn_guide_blur_k=31)
    cfg = RenderConfig(steps=GUIDE_STEPS, sampler="DDIM", guidance=gcfg, **b1)
    got = render(f"attention guidance b1 DDIM {GUIDE_STEPS} (rounds 4, scale 1.1, blur 31)",
                 bundle, cfg, [(GUIDE_STEPS, ucfg, 64, 2, None), (4, ucfg, 64, 1, None)])
    paths["attn_guide_b1_ddim50"] = got[2]
    compare(f"attention guidance b1 DDIM {GUIDE_STEPS}", got, refs_b1[GUIDE_STEPS], 1)
    # one guided step's eps at a 16x16 latent, the UNet in f32 (TF32 off),
    # against the CPU plain twins on copies of the same weights
    cpu = torch.device("cpu")
    b32 = bundle.cast("float32")
    cfg32, p32 = b32.unet_cfg, b32.unet_params
    p32_cpu = _tree_map(lambda a: a.to(cpu), p32)
    spec = make_guidance_spec(bundle, PROMPT16)
    spec_cpu = GuidanceSpec(*(a.to(cpu) for a in (spec.uncond, spec.factors, spec.scales,
                                                  spec.masks)))
    it = S.make_inference_tables(bundle.tables, GUIDE_STEPS)
    idx = 2
    coeffs = (np.float32(it.alphas_cumprod_t[idx]),
              np.float32(it.sqrt_one_minus_alphas_cumprod_t[idx]))
    x16 = torch.randn((1, 16, 16, 4), generator=torch.Generator().manual_seed(5))
    t16 = int(it.timesteps[idx])
    gcfg16 = dataclasses.replace(gcfg, attn_guide_blur_k=7)

    def guided(p, x_, sp):
        def eps(a, tt, c):
            return M.unet_apply(cfg32, p, a, tt, c)

        def eps_skips(a, tt, c):
            return M.unet_apply(cfg32, p, a, tt, c, return_skips=True)

        return cfg_epsilon_attn_guided(eps, eps_skips, x_, torch.tensor(t16, device=x_.device),
                                       sp, 7.5, coeffs, gcfg=gcfg16)

    with torch.inference_mode():
        got_e = guided(p32, x16.to(dev), spec).cpu()
        want_e = guided(p32_cpu, x16, spec_cpu)
        plain_e = cfg_epsilon(lambda a, tt, c: M.unet_apply(cfg32, p32_cpu, a, tt, c), x16,
                              torch.tensor(t16), spec_cpu, 7.5)
    rel = float((got_e - want_e).norm() / want_e.norm())
    moved = float((want_e - plain_e).norm() / plain_e.norm())
    print(f"phase16: (d) one attention-guided eps, f32 UNet (TF32 off) at a 16x16 latent (blur "
          f"7), CUDA kernels vs CPU plain twins: rel L2 {rel:.3e} (tol 1e-4); the guidance moves "
          f"eps by rel {moved:.3e} ({card})", flush=True)
    if not rel <= 1e-4 or not moved > 0:
        raise SmokeFailure(f"the attention-guided eps: rel {rel}, moved {moved}")
    del b32, p32, p32_cpu
    torch.cuda.empty_cache()

    # (e) tiled inference: 1024x1024 b1 DDIM 20, 64-latent tiles every 48,
    # 2 tiles a call (UNet batch 4); a single 64 tile at 512x512 is the
    # untiled render, bit for bit (phase (c)'s exact b1 DDIM 20)
    pos = tile_positions(128, 64, 48)
    n_tiles = len(pos) ** 2
    chunks = -(-n_tiles // 2)
    cfg = RenderConfig(steps=TILE_STEPS, sampler="DDIM", unet_tile=64, unet_tile_stride=48,
                       unet_tile_chunk=2, **dict(b1, width=1024, height=1024))
    got = render(f"tiled 1024x1024 b1 DDIM {TILE_STEPS} ({n_tiles} tiles at {pos}, 2 a call)",
                 bundle, cfg, [(chunks * TILE_STEPS, ucfg, 64, 4, None)])
    paths["tiled_1024_b1_ddim20"] = got[2]
    one = render(f"single tile 512x512 b1 DDIM {TILE_STEPS} (unet_tile 64)", bundle,
                 RenderConfig(steps=TILE_STEPS, sampler="DDIM", unet_tile=64, **b1),
                 [(TILE_STEPS, ucfg, 64, 2, None)])
    paths["tiled_single_512_b1_ddim20"] = one[2]
    same = torch.equal(one[0], refs_b1[TILE_STEPS][0])
    print(f"phase16: (e) the single-tile 512x512 render against the untiled one: latents "
          f"torch.equal {same} ({card})", flush=True)
    if not same:
        raise SmokeFailure("the single-tile render differs from the untiled one")
    del bundle, tome_bundle
    torch.cuda.empty_cache()
    return paths


NULL_STEPS = 20  # DDIM steps of phase 17's null-text inversion
NULL_INNER = 5  # its Adam iterations a step
TRAIN_STEPS = 3  # phase 17's SD-1.5 train steps
LOGLIK_RK4_STEPS = 4  # its "Log" RK4 steps at 512x512 (4 VJPs a step)
LOGLIK_DOPRI5_T_START = 3  # its dopri5 at a 16x16 latent: the last 3 of 20 sigmas (0.36 -> 0.03)
GRAD_CPU_TOL = 1e-4  # phase 17(b): f32 loss and gradients at a 16x16 latent vs the CPU copies
# the backward rule beside each kernel of the kernels line: the VJP of the
# plain twin recomputed on the saved inputs (``_build.kernel_with_plain_vjp``)
# for every body under a dispatch entry; the probes have none (as in JAX)
BACKWARD = {"attention": "plain recompute (VJP of ops.attention.attention_plain)",
            "geglu_ff": "plain recompute (VJP of ops.mlp.geglu_ff_plain)",
            "group_norm": "plain recompute (VJP of ops.groupnorm.group_norm_plain)",
            "group_norm_cat": "plain recompute (VJP of ops.groupnorm.group_norm_silu_cat_plain)",
            "conv3x3": "plain recompute (VJP of ops.conv.conv3x3_plain)",
            "attention_cm": "plain recompute (VJP of ops.attention.attention_dmajor_plain)",
            "winograd": "plain recompute (VJP of ops.probes.winograd.wino3x3_plain)"}


def grad_wiring_cases(dev) -> list:
    """Phase 17(a)'s cases: (label, dispatch entry, its plain twin, tensors,
    other arguments, counter, the forward's planned kernels). Every body a
    dispatch entry reaches: K1 sm90 bf16, fused f32, 3xTF32 f32 and bf16
    wide; K5 bf16 and f32 (the latter through its out_hdbs view); K2 bf16
    (f32 master weights) and f32; K3 bf16 and f32 with and without SiLU;
    K4 sm90 (its bias needs no gradient), f32 and generic; K6 bf16 and
    f32; K3's two-source form (two outputs)."""
    import importlib

    import torch

    from complex_prompt_diffusion_tpu_torch.ops import conv as C
    from complex_prompt_diffusion_tpu_torch.ops import groupnorm as G
    from complex_prompt_diffusion_tpu_torch.ops import mlp as F2
    from complex_prompt_diffusion_tpu_torch.ops.probes import winograd as W

    # ops/__init__ re-exports the function ``attention``: the module by name
    A = importlib.import_module("complex_prompt_diffusion_tpu_torch.ops.attention")
    bf, f32 = torch.bfloat16, torch.float32
    g = torch.Generator(device=dev).manual_seed(17)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def leaf(shape, dtype=f32, scale=1.0, grad=True):
        t = (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)
        return t.requires_grad_(grad)

    def conv_w(co, c, dtype=f32):
        w = (torch.randn((co, c, 3, 3), generator=g, device=dev) * (9 * c) ** -0.5).to(dtype)
        return w.contiguous(memory_format=torch.channels_last).requires_grad_()

    def qkv(shape, dtype):
        return tuple(leaf(shape, dtype) for _ in range(3))

    def ff(dtype_x, c=320):
        return (leaf((2, 1024, c), dtype_x), leaf((c, 8 * c), f32, c ** -0.5),
                leaf(8 * c, f32, 0.1), leaf((4 * c, c), f32, (4 * c) ** -0.5), leaf(c, f32, 0.1))

    def gn(dtype, silu):
        x = leaf((2, 32, 32, 640), dtype, 2.0)
        return ("K3 " + ("bf16" if dtype == bf else "f32") + (" SiLU" if silu else ""),
                G.group_norm_nhwc, G.group_norm_plain,
                (x, (1 + leaf(640, f32, 0.1, grad=False)).requires_grad_(), leaf(640, f32, 0.1)),
                (32, 1e-5, silu), G.group_norm_nhwc,
                G.group_norm_plan(2, 1024, 640, 32, dtype, sms).launches)

    def wino_twin(x, k, b):
        return W.wino3x3_plain(x, W.winograd_weights(k).to(x.dtype), b)

    def hwio(co, c):
        return (torch.randn((3, 3, c, co), generator=g, device=dev) * (9 * c) ** -0.5
                ).requires_grad_()

    s5 = 40 ** -0.5
    return [
        ("K1 sm90 bf16", A.flash_attention, A.attention_plain, qkv((2, 1024, 320), bf), (8,),
         A.flash_attention, 1),
        ("K1 fused 3xTF32 f32", A.flash_attention, A.attention_plain, qkv((2, 1024, 320), f32),
         (8,), A.flash_attention, 1),
        ("K1 3xTF32 f32 d512", A.flash_attention, A.attention_plain, qkv((1, 1024, 512), f32),
         (1,), A.flash_attention, A.f32_sm90_launches(1, 1, 1024, 1024)),
        ("K1 bf16 wide d512", A.flash_attention, A.attention_plain, qkv((1, 1024, 512), bf),
         (1,), A.flash_attention, A.bf16_wide_launches(1, 1, 1024, 1024)),
        ("K5 bf16", A.attention_dmajor, A.attention_dmajor_plain, qkv((2, 8, 40, 1024), bf),
         (s5, False, False), A.attention_dmajor, 1),
        ("K5 f32 out_hdbs", A.attention_dmajor, A.attention_dmajor_plain,
         qkv((2, 8, 40, 1024), f32), (s5, False, True), A.attention_dmajor, 1),
        ("K2 bf16 (f32 master weights)", F2.geglu_ff, F2.geglu_ff_plain, ff(bf), (),
         F2.geglu_ff, F2.geglu_plan(2048, 320, 1280).launches),
        ("K2 f32", F2.geglu_ff, F2.geglu_ff_plain, ff(f32), (), F2.geglu_ff,
         F2.geglu_plan(2048, 320, 1280, f32).launches),
        gn(bf, False), gn(bf, True), gn(f32, False), gn(f32, True),
        # the two-source form: two outputs, a cotangent each; its slab form
        # at 16^2 (one launch), its split form at 32^2 (two)
        ("K3 two-source bf16 SiLU (1280 | 640 at 16^2, slab)", G.group_norm_silu_cat,
         G.group_norm_silu_cat_plain,
         (leaf((2, 16, 16, 1280), bf, 2.0), leaf((2, 16, 16, 640), bf, 2.0),
          (1 + leaf(1920, f32, 0.1, grad=False)).requires_grad_(), leaf(1920, f32, 0.1)),
         (32, 1e-5, True), G.group_norm_silu_cat,
         G.group_norm_cat_plan(2, 256, 1280, 640, 32, 132).launches),
        ("K3 two-source bf16 SiLU (640 | 320 at 32^2, split)", G.group_norm_silu_cat,
         G.group_norm_silu_cat_plain,
         (leaf((2, 32, 32, 640), bf, 2.0), leaf((2, 32, 32, 320), bf, 2.0),
          (1 + leaf(960, f32, 0.1, grad=False)).requires_grad_(), leaf(960, f32, 0.1)),
         (32, 1e-5, True), G.group_norm_silu_cat,
         G.group_norm_cat_plan(2, 1024, 640, 320, 32, 132).launches),
        ("K4 sm90 (f32 master weight; bias needs none)", C.conv3x3, C.conv3x3_plain,
         (leaf((2, 32, 32, 320), bf), conv_w(640, 320), leaf(640, f32, 0.1, grad=False)), (),
         C.conv3x3, 1),
        ("K4 f32", C.conv3x3, C.conv3x3_plain,
         (leaf((2, 16, 16, 640)), conv_w(640, 640), leaf(640, f32, 0.1)), (), C.conv3x3, 1),
        ("K4 generic bf16 (C % 8 != 0)", C.conv3x3, C.conv3x3_plain,
         (leaf((2, 16, 16, 20), bf), conv_w(320, 20), leaf(320, f32, 0.1)), (), C.conv3x3, 1),
        ("K4 narrow-C bf16 (conv_in)", C.conv3x3, C.conv3x3_plain,
         (leaf((2, 16, 16, 4), bf), conv_w(320, 4), leaf(320, f32, 0.1)), (), C.conv3x3_narrow,
         1),
        ("K4 narrow-Co f32 (out conv)", C.conv3x3, C.conv3x3_plain,
         (leaf((2, 16, 16, 320)), conv_w(4, 320), leaf(4, f32, 0.1)), (), C.conv3x3_narrow, 1),
        ("K6 bf16", W.wino3x3, wino_twin, (leaf((2, 16, 16, 640), bf), hwio(640, 640),
                                           leaf(640, f32, 0.1)), (), W.wino3x3,
         W.wino3x3_plan(2, 16, 16, 640, 640).launches),
        ("K6 f32", W.wino3x3, wino_twin, (leaf((2, 16, 16, 640)), hwio(640, 640),
                                          leaf(640, f32, 0.1)), (), W.wino3x3,
         W.wino3x3_plan(2, 16, 16, 640, 640, dtype=f32).launches),
    ]


def phase17_grads(dev, card: str) -> dict:
    """(a): every dispatched body under grad. Its forward launches the
    kernel (the counter moves by the planned kernels, the output has the
    bits of a call without grad), the backward launches none, and the
    gradients for a random cotangent equal autograd's through the plain
    twin on the same inputs (torch.equal), each in its input's dtype, None
    where an input needs none; K7-K9 still raise under grad."""
    import torch

    from complex_prompt_diffusion_tpu_torch.ops.probes.attention import attention_probe
    from complex_prompt_diffusion_tpu_torch.ops.probes.groupnorm import group_norm_probe
    from complex_prompt_diffusion_tpu_torch.ops.probes.stream import stream_copy

    reset_launches()
    cases = grad_wiring_cases(dev)
    g = torch.Generator(device=dev).manual_seed(170)
    for label, fn, twin, args, rest, counter, planned in cases:
        n0 = counter.launches
        with torch.no_grad():
            ref_out = fn(*args, *rest)
        n1 = counter.launches
        out = fn(*args, *rest)
        n2 = counter.launches
        # a two-output entry (K3's two-source form) takes a cotangent each
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref_out if isinstance(ref_out, tuple) else (ref_out,)
        wrt = [a for a in args if a.requires_grad]
        cot = [torch.randn(o.shape, generator=g, device=dev).to(o.dtype) for o in outs]
        got = torch.autograd.grad(outs, wrt, cot, retain_graph=True)
        none_ok = all(r is None for r, a in zip(outs[0].grad_fn.apply(*cot)[3:], args)
                      if not a.requires_grad)
        torch.cuda.synchronize()
        n3 = counter.launches
        want = torch.autograd.grad(twin(*args, *rest), wrt, cot)
        equal = all(a.dtype == x.dtype and torch.equal(a, b) for a, b, x in zip(got, want, wrt))
        ok = (n1 - n0 == planned and n2 - n1 == planned and n3 == n2 and none_ok and equal
              and all(torch.equal(o, r) for o, r in zip(outs, refs))
              and outs[0].grad_fn is not None)
        print(f"phase17: (a) {label}: forward {n2 - n1} kernels under grad (planned {planned}), "
              f"backward 0 ({n3 - n2}); {len(wrt)} gradients torch.equal the plain twin's "
              f"{equal}, dtypes {[str(a.dtype)[6:] for a in got]}; None where none is needed "
              f"{none_ok} ({card})", flush=True)
        if not ok:
            raise SmokeFailure(f"the backward rule of {label}: launches {n0} {n1} {n2} {n3} "
                               f"(planned {planned}), gradients equal {equal}, None {none_ok}")
    q = torch.randn((1, 256, 40), device=dev, dtype=torch.bfloat16, requires_grad=True)
    x = torch.randn((1, 8, 8, 320), device=dev, dtype=torch.bfloat16, requires_grad=True)
    ones = torch.ones(320, device=dev, dtype=torch.bfloat16)
    for label, call in (("K7", lambda: attention_probe(q, q, q, 1, 0.158)),
                        ("K8", lambda: group_norm_probe(x, ones, ones)),
                        ("K9", lambda: stream_copy(x.reshape(1, 64, 320), 64))):
        try:
            call()
        except RuntimeError as e:
            if "no backward rule" not in str(e):
                raise
        else:
            raise SmokeFailure(f"the probe {label} ran under grad: it has no backward rule")
    print(f"phase17: (a) K7, K8 and K9 raise under grad (no backward rule, as in the JAX "
          f"package) ({card})", flush=True)
    return read_launches()


def phase17_train(dev, card: str, bundle, latent: int = 64) -> dict:
    """(b): the training step at SD-1.5 full width (f32 master weights,
    bf16 compute, batch 2 at 512x512, random context, Adan lr 1e-4,
    LitEma): s/step and peak memory over TRAIN_STEPS steps, each step's
    K1-K4 launches as its UNet call predicts (``check_calls``), one step's
    gradients computed apart (every one finite; the backward launches
    nothing); then one step's loss and five gradients in f32 at a 16x16
    latent against CPU copies. ``latent``: the side of the train batch's
    latents (64: 512x512)."""
    import numpy as np
    import torch

    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch import train as T
    from complex_prompt_diffusion_tpu_torch.pipeline import _tree_map
    from complex_prompt_diffusion_tpu_torch.train.loop import LitEma
    from complex_prompt_diffusion_tpu_torch.train.optimizers import tree_leaves, tree_map

    ucfg, tables = bundle.unet_cfg, bundle.tables
    params = _tree_map(lambda a: a.float(), bundle.unet_params)  # f32 master weights
    g = torch.Generator(device=dev).manual_seed(171)
    ctx_dim = ucfg.context_dim
    batch = {"latents": torch.randn((2, latent, latent, 4), generator=g, device=dev),
             "context": torch.randn((2, 77, ctx_dim), generator=g, device=dev)}
    opt = T.adan(learning_rate=1e-4)
    step = T.make_train_step(ucfg, tables, opt)
    state = opt.init(params)
    ema = LitEma.create(params)
    first = tree_leaves(params)
    # one step's gradients apart: the forward's launches, none in the backward
    t = torch.randint(0, 1000, (2,), generator=g, device=dev)
    noise = torch.randn((2, latent, latent, 4), generator=g, device=dev)
    leaves = [p.detach().requires_grad_() for p in first]
    it = iter(leaves)
    diff = tree_map(lambda _: next(it), params)
    reset_launches()
    loss = T.p_losses(lambda p, x, tt, c: M.unet_apply(ucfg, p, x, tt, c), diff, tables,
                      batch["latents"], batch["context"], t, noise)
    torch.cuda.synchronize()
    fwd = read_launches()
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    after = read_launches()
    check_calls(fwd, "the train step's forward", [(1, ucfg, latent, 2, None)])
    finite = all(bool(torch.isfinite(gr).all()) for gr in grads)
    if after != fwd or not finite or not bool(torch.isfinite(loss)):
        raise SmokeFailure(f"the train step's backward: launches {after} after {fwd}, "
                           f"gradients finite {finite}, loss {float(loss)}")
    del leaves, diff, grads, loss
    torch.cuda.empty_cache()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        params, state, loss = step(params, state, batch, g)
        ema = ema.update(params)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = read_launches()
    check_calls(launches, f"{TRAIN_STEPS} train steps", [(TRAIN_STEPS, ucfg, latent, 2, None)])
    moved = sum(not torch.equal(a, b) for a, b in zip(tree_leaves(params), first))
    shadow_ok = all(bool(torch.isfinite(a).all()) for a in tree_leaves(ema.shadow))
    losses = [float(v) for v in losses]
    print(f"phase17: (b) SD-1.5 train step, batch 2 at {8 * latent}x{8 * latent} ({latent}x"
          f"{latent} latents), f32 master "
          f"weights, bf16 compute, Adan lr 1e-4, LitEma on {card}: {dt:.4f} s/step over "
          f"{TRAIN_STEPS} steps (with the EMA update), peak memory {peak:.2f} GiB; losses "
          f"{[round(v, 5) for v in losses]}; {moved} of {len(first)} parameter tensors moved; "
          f"every gradient of one step finite; a step's forward launched K1 sm90 "
          f"{fwd['attention_sm90']}, K2 {fwd['geglu_ff']}, K3 {fwd['group_norm']} kernels for "
          f"{fwd['group_norm calls']} calls, K4 {fwd['conv3x3']} ({fwd['conv3x3_sm90']} sm90) as "
          f"its UNet call predicts; its backward launched none", flush=True)
    if not all(np.isfinite(losses)) or moved < len(first) // 2 or not shadow_ok:
        raise SmokeFailure(f"the train steps: losses {losses}, {moved} tensors moved, EMA "
                           f"finite {shadow_ok}")
    del params, state, ema, first
    torch.cuda.empty_cache()

    # one step's loss and five gradients in f32 at a 16x16 latent against
    # CPU copies of the same weights (TF32 off)
    cfg32 = dataclasses.replace(ucfg, dtype="float32")
    p32 = _tree_map(lambda a: a.float(), bundle.unet_params)
    cpu = torch.device("cpu")
    gc = torch.Generator().manual_seed(172)
    x16 = torch.randn((2, 16, 16, 4), generator=gc)
    ctx16 = torch.randn((2, 77, ctx_dim), generator=gc)
    noise16, t16 = torch.randn((2, 16, 16, 4), generator=gc), torch.tensor([151, 777])
    named = {"conv_in": lambda p: p["input_blocks"][0][0]["weight"],
             "K4-gated conv (level 0 ResBlock in_conv, 16x16 plane)":
                 lambda p: p["input_blocks"][1][0]["in_conv"]["weight"],
             "GEGLU w1 (level 0)": lambda p: p["input_blocks"][1][1]["blocks"][0]["ff"]["proj"]
                                            ["kernel"],
             "GroupNorm scale (level 0 ResBlock in_norm)":
                 lambda p: p["input_blocks"][1][0]["in_norm"]["scale"],
             "self-attention wq (level 0)": lambda p: p["input_blocks"][1][1]["blocks"][0]
                                                      ["attn1"]["to_q"]["kernel"]}

    def loss_and_grads(p, device):
        leaves_ = [a.detach().requires_grad_() for a in tree_leaves(p)]
        it_ = iter(leaves_)
        d = tree_map(lambda _: next(it_), p)
        lv = T.p_losses(lambda pp, x, tt, c: M.unet_apply(cfg32, pp, x, tt, c), d, tables,
                        x16.to(device), ctx16.to(device), t16.to(device), noise16.to(device))
        targets = [f(d) for f in named.values()]
        return float(lv.detach()), [gr.cpu() for gr in torch.autograd.grad(lv, targets)]

    reset_launches()
    l_dev, g_dev = loss_and_grads(p32, dev)
    n = read_launches()
    p_cpu = _tree_map(lambda a: a.to(cpu), p32)
    l_cpu, g_cpu = loss_and_grads(p_cpu, cpu)
    rels = [rel_err(a, b)[1] for a, b in zip(g_dev, g_cpu)]
    l_rel = abs(l_dev - l_cpu) / abs(l_cpu)
    print(f"phase17: (b) one step in f32 (TF32 off) at a 16x16 latent, UNet batch 2, CUDA "
          f"kernels (K1 fused f32 {n['attention_f32_fused_sm90']}, K2 f32 "
          f"{n['geglu_ff_f32_sm90']} kernels, K3 {n['group_norm']}, K4 {n['conv3x3']} "
          f"({n['conv3x3_f32_sm90']} on its f32 body)) and their plain backward vs the CPU plain "
          f"twins: loss {l_dev:.6f} vs {l_cpu:.6f} (rel {l_rel:.3e}); gradients rel "
          + ", ".join(f"{k} {r:.3e}" for k, r in zip(named, rels))
          + f" (tol {GRAD_CPU_TOL:.0e}) ({card})", flush=True)
    if (not l_rel <= GRAD_CPU_TOL or not all(r <= GRAD_CPU_TOL for r in rels)
            or n["conv3x3_f32_sm90"] <= 0 or n["attention_f32_fused_sm90"] <= 0):
        raise SmokeFailure(f"the f32 train step at 16x16 against the CPU: loss rel {l_rel}, "
                           f"gradients rel {rels}, launches {n}")
    del p32, p_cpu
    torch.cuda.empty_cache()
    return launches


def phase17_null_inversion(dev, card: str, bundle, image) -> dict:
    """(c): null-text inversion of a phase-2 image at 512x512 b1: its
    ``encode_image`` latents, DDIM NULL_STEPS steps, NULL_INNER Adam
    iterations a step, cond from ``encode_prompt``, CFG 7.5 (the uncond
    and cond pair in one UNet call at batch 2). The table [steps, 1, 77,
    768] is finite, and the mean over the steps of the DDIM-step loss with
    the optimized uncond lies below that with the start, both computed with
    the port's DDIM coefficients."""
    import numpy as np
    import torch

    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch import schedules as S
    from complex_prompt_diffusion_tpu_torch.pipeline import encode_image, encode_prompt
    from complex_prompt_diffusion_tpu_torch.prompts.null_inversion import (
        ddim_invert_loop,
        null_text_inversion,
    )

    ucfg, params = bundle.unet_cfg, bundle.unet_params
    z0 = encode_image(bundle, image[None])
    cond = encode_prompt(bundle, PROMPT16)
    uncond = encode_prompt(bundle, "")
    cond_c = cond.clone()  # out of inference mode: the UNet's context under grad
    it = S.make_inference_tables(bundle.tables, NULL_STEPS)

    def unet(x, t, ctx):
        return M.unet_apply(ucfg, params, x, t.reshape(-1).expand(x.shape[0]), ctx)

    def cond_eps(x, t):
        return unet(x, t, cond_c)

    def cfg_eps(x, t, u):
        e = unet(torch.cat([x, x]), t, torch.cat([u, cond_c]))
        return e[:1], e[1:]

    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    x_T, table = null_text_inversion(cond_eps, cfg_eps, z0, uncond, it,
                                     num_inner_steps=NULL_INNER)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = read_launches()
    side = z0.shape[1]
    n = it.num_steps
    check_calls(launches, "null-text inversion",
                [(n, ucfg, side, 1, None), (n * NULL_INNER, ucfg, side, 2, None)])
    a_t = np.asarray(it.alphas_cumprod_t, np.float32)
    a_prev = np.asarray(it.alphas_cumprod_prev_t, np.float32)
    one = np.float32(1)
    with torch.inference_mode():
        latents = ddim_invert_loop(cond_eps, z0, it)

        def loss(idx, u):
            x = latents[idx + 1]
            e_u, e_c = cfg_eps(x, torch.tensor(int(it.timesteps[idx]), device=dev), u)
            eps = e_u + 7.5 * (e_c - e_u)
            x0 = (x - float(np.sqrt(one - a_t[idx])) * eps) / float(np.sqrt(a_t[idx]))
            x_prev = float(np.sqrt(a_prev[idx])) * x0 + float(np.sqrt(one - a_prev[idx])) * eps
            return float(((x_prev - latents[idx]) ** 2).mean())

        start = float(np.mean([loss(idx, uncond) for idx in range(n)]))
        final = float(np.mean([loss(n - 1 - i, table[i]) for i in range(n)]))
    same_x = bool(torch.equal(latents[-1], x_T))
    print(f"phase17: (c) null-text inversion of a phase-2 image at {image.shape[1]}x"
          f"{image.shape[0]} b1, DDIM {n} steps x {NULL_INNER} Adam iterations, CFG 7.5 (UNet "
          f"batch 2 under grad w.r.t. the uncond) on {card}: {wall:.3f} s wall, peak memory "
          f"{peak:.2f} GiB with the bundle ({n} inversion calls, {n * NULL_INNER} value-and-grad "
          f"calls); table {list(table.shape)} finite "
          f"{bool(torch.isfinite(table).all())}; mean DDIM-step loss {start:.6e} with the start "
          f"uncond, {final:.6e} with the table; x_T equals a second inversion {same_x}; "
          f"launches K1 sm90 {launches['attention_sm90']}, K2 {launches['geglu_ff']}, K3 "
          f"{launches['group_norm']}, K4 {launches['conv3x3']}", flush=True)
    if (tuple(table.shape) != (n, 1, 77, ucfg.context_dim)
            or not bool(torch.isfinite(table).all())
            or not final < start or not same_x):
        raise SmokeFailure(f"null-text inversion: table {list(table.shape)}, loss {start} -> "
                           f"{final}, x_T repeatable {same_x}")
    return launches


def phase17_loglik(dev, card: str, bundle, sides=(512, 128)) -> dict:
    """(d): the "Log" sampler through ``sample_latents``: 512x512 b1 with
    the fixed-grid RK4 (LOGLIK_RK4_STEPS steps: 4 VJPs a step through the
    CFG UNet at batch 2), and dopri5 (its default) at a 16x16 latent at
    full width with its NFE, over the last LOGLIK_DOPRI5_T_START steps of
    the schedule (``t_start``); finite log-likelihoods of shape [B].
    ``sides``: the two renders' pixel sides."""
    import torch

    from complex_prompt_diffusion_tpu_torch.pipeline import (
        RenderConfig,
        make_guidance_spec,
        sample_latents,
    )

    spec = make_guidance_spec(bundle, PROMPT16)
    ucfg = bundle.unet_cfg
    out = {}
    for label, side, steps, t_start in (
            (f"rk4_{sides[0]}", sides[0], LOGLIK_RK4_STEPS, None),
            (f"dopri5_{sides[1]}", sides[1], None, LOGLIK_DOPRI5_T_START)):
        cfg = RenderConfig(sampler="Log", width=side, height=side, steps=20, seed=3)
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with UNetCallKinds() as kinds:
            t0 = time.perf_counter()
            ll = sample_latents(bundle, spec, cfg, t_start=t_start, loglik_steps=steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = read_launches()
        nfe = len(kinds.calls)
        if steps is not None and nfe != 4 * steps:
            raise SmokeFailure(f"Log RK4 {steps} steps made {nfe} UNet calls, want {4 * steps}")
        check_calls(launches, f"Log {label}", [(nfe, ucfg, side // 8, 2, None)])
        print(f"phase17: (d) \"Log\" through sample_latents, {side}x{side} b1, "
              + (f"RK4 {steps} steps" if steps else
                 f"dopri5 (atol = rtol = 1e-4) over the last {t_start} of 20 steps")
              + f", CFG 7.5: {nfe} UNet VJPs (NFE) at UNet batch 2 in {wall:.3f} s "
              f"({wall / nfe:.4f} s a VJP), peak memory {peak:.2f} GiB with the bundle; "
              f"log-likelihood {[round(float(v), 3) for v in ll]} "
              f"nats, shape {list(ll.shape)} ({card})", flush=True)
        if tuple(ll.shape) != (1,) or not bool(torch.isfinite(ll).all()):
            raise SmokeFailure(f"Log {label}: log-likelihoods {ll}")
        out[f"loglik_{label}"] = launches
    return out


def phase17(dev, card: str, image) -> dict:
    """Gradients through the kernels at SD-1.5 full width (phase 2's bundle
    rebuilt from seed 0: bf16 UNet, bf16 VAE): (a) every dispatched body
    under grad; (b) the training step; (c) null-text inversion; (d) the
    "Log" sampler. Returns the launch counts by path."""
    import torch

    from complex_prompt_diffusion_tpu_torch.pipeline import ModelBundle

    paths = {"grad_wiring": phase17_grads(dev, card)}
    t0 = time.perf_counter()
    bundle = ModelBundle.random("sd15", seed=0, device=dev).cast_vae("bfloat16")
    torch.cuda.synchronize()
    print(f"phase17: SD-1.5 random bundle of phase 2 rebuilt in {time.perf_counter() - t0:.2f} "
          f"s", flush=True)
    paths["train_step_b2"] = phase17_train(dev, card, bundle)
    paths["null_text_inversion_b1"] = phase17_null_inversion(dev, card, bundle, image)
    paths.update(phase17_loglik(dev, card, bundle))
    del bundle
    torch.cuda.empty_cache()
    return paths


CG_STEPS = 20  # DDIM steps of phase 18's CLIP-guided renders and its hypernetwork render
CG_PLMS_STEPS = 10  # PLMS steps of its 2-factor guided render (11 evaluations)
CG_CUTOUTS = 4  # cutouts a step of its standalone CLIP-guided txt2img
HYPER_HIDDEN = 1536  # the hypernetwork's hidden width: the A1111 layer structure [1, 2, 1] at 768
CG_CPU_TOL = 1e-4  # phase 18(e): one f32 CLIP-guided eps at a 16x16 latent vs the CPU copies
HYPER_CPU_TOL = 1e-5  # and one f32 hypernetwork UNet eval


def phase18_towers(dev, card: str, bundle) -> None:
    """(a): the guide CLIP's towers at full width, f32 with TF32 off, on the
    card against the CPU port on the same weights: ViT-B/32 and ViT-L/14
    (random weights, batch 4, 224^2, projected) and SD-1.5's text tower
    (the bundle's) at "pooled" and "hidden" (layer_idx 11)."""
    import torch

    from complex_prompt_diffusion_tpu_torch import convert
    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch.pipeline import _tree_map

    cpu = torch.device("cpu")
    gen = torch.Generator(device=dev).manual_seed(18)
    for name, vcfg in (("ViT-B/32", M.CLIPVisionConfig.vit_b32()),
                       ("ViT-L/14", M.CLIPVisionConfig.vit_l14())):
        params = convert.clip_vision_params(M.init_clip_vision(gen, vcfg, dev), dev)
        side = vcfg.image_size
        images = torch.randn((4, side, side, 3), generator=gen, device=dev)
        with torch.inference_mode():
            M.clip_vision_apply(vcfg, params, images)  # the first call's set-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = M.clip_vision_apply(vcfg, params, images)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            want = M.clip_vision_apply(vcfg, _tree_map(lambda a: a.to(cpu), params), images.cpu())
        err = rel_err(got.cpu(), want)
        print(f"phase18: (a) {name} vision tower b4 {side}^2 f32 (TF32 off, {vcfg.num_patches + 1} "
              f"tokens, {vcfg.num_layers} layers): [4, {vcfg.projection_dim}] on the card vs the "
              f"CPU port: max rel {err[1]:.3e} (tol {TOL['float32']:.0e}); {ms:.2f} ms ({card})",
              flush=True)
        if tuple(got.shape) != (4, vcfg.projection_dim) or not err[1] <= TOL["float32"]:
            raise SmokeFailure(f"the {name} vision tower: {list(got.shape)}, rel {err[1]}")
    tokens = torch.as_tensor(bundle.tokenizer([PROMPT16, "a red dragon"]), device=dev)
    clip_cpu = _tree_map(lambda a: a.to(cpu), bundle.clip_params)
    d = bundle.clip_cfg.hidden_size
    for layer, idx, shape in (("pooled", None, (2, d)), ("hidden", 11, (2, 77, d))):
        with torch.inference_mode():
            got = M.clip_text_apply(bundle.clip_cfg, bundle.clip_params, tokens, layer=layer,
                                    layer_idx=idx)
            want = M.clip_text_apply(bundle.clip_cfg, clip_cpu, tokens.cpu(), layer=layer,
                                     layer_idx=idx)
        err = rel_err(got.cpu(), want)
        print(f"phase18: (a) SD-1.5 text tower layer={layer!r}"
              + (f" layer_idx {idx}" if idx else "") + f" b2: {list(got.shape)} vs the CPU port: "
              f"max rel {err[1]:.3e} (tol {TOL['float32']:.0e}) ({card})", flush=True)
        if tuple(got.shape) != shape or not err[1] <= TOL["float32"]:
            raise SmokeFailure(f"the text tower's {layer} layer: {list(got.shape)}, rel {err[1]}")


def unit_text_embedding(dev, width: int, seed: int):
    """A unit random guide text embedding [width] (random weights have no
    guide CLIP text tower to encode one)."""
    import torch

    e = torch.randn((width,), generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    return e / e.norm()


def guided_render(label: str, card: str, run, calls, f32_decodes: int, steps: int, want_calls):
    """One guided path: launch counts at 0, ``run()`` timed to a sync (its
    peak memory), the UNet calls by batch against ``want_calls`` (a sorted
    list of batches), the K1-K4 launches against ``calls`` and the f32
    decodes (``check_calls``: forwards only, so the backward launched
    none). Returns (run's result, launches, seconds)."""
    import torch

    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with UNetCallKinds() as kinds:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = read_launches()
    batches = sorted(b for b, _ in kinds.calls)
    if batches != want_calls:
        raise SmokeFailure(f"{label}: UNet calls at batches {batches}, want {want_calls}")
    check_calls(launches, label, calls, f32_decodes=f32_decodes)
    groups = [(n, ub) for n, _, _, ub, _ in calls]
    print(f"phase18: {label} on {card}: {wall:.3f} s = {wall / steps:.4f} s/step, peak memory "
          f"{peak:.2f} GiB with the bundle; {len(batches)} UNet calls ((calls, UNet batch) "
          f"{groups}), {f32_decodes} f32 decodes; launches K1 sm90 {launches['attention_sm90']}, "
          f"K1 3xTF32 {launches['attention_f32_sm90']}, K2 {launches['geglu_ff']}, K3 "
          f"{launches['group_norm']} kernels for {launches['group_norm calls']} calls, K4 sm90 "
          f"{launches['conv3x3_sm90']} (each as its UNet calls and decodes predict: none in a "
          f"backward)", flush=True)
    return out, launches, wall


def phase18(dev, card: str) -> dict:
    """CLIP guidance and hypernetworks at SD-1.5 full width (phase 2's bundle
    rebuilt from seed 0: UNet bf16, VAE f32; 512x512): (a) the towers
    against the CPU port; (b) ``sample_latents(clip_guidance=)``: DDIM 20 b1
    with a ViT-B/32 guide against the unguided render of the same start,
    then PLMS 10 on a 2-factor prompt at factor_limit 2; (c) the standalone
    ``clip_guided_txt2img`` with a ViT-L/14 guide, 4 cutouts and the pooled
    SD text embedding as its text; (d) txt2img with a random hypernetwork on
    every cross-attention site (hoisted k/v); (e) one guided eps and one
    hypernetwork UNet eval in f32 at a 16x16 latent against the CPU copies.
    Returns the launch counts by path."""
    import torch

    from complex_prompt_diffusion_tpu_torch import convert
    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch.guidance.clip_guidance import (
        ClipGuidanceConfig,
        make_clip_guidance,
    )
    from complex_prompt_diffusion_tpu_torch.models.params import attach_hypernetwork
    from complex_prompt_diffusion_tpu_torch.pipeline import (
        ModelBundle,
        RenderConfig,
        _tree_map,
        initial_noise,
        make_guidance_spec,
        sample_latents,
        txt2img,
    )
    from complex_prompt_diffusion_tpu_torch.pipeline_clip_guided import clip_guided_txt2img
    from complex_prompt_diffusion_tpu_torch.prompts import CompositionalPrompt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paths = {}
    t0 = time.perf_counter()
    bundle = ModelBundle.random("sd15", seed=0, device=dev)
    torch.cuda.synchronize()
    ucfg = bundle.unet_cfg
    print(f"phase18: SD-1.5 random bundle of phase 2 (seed 0; UNet bf16, VAE f32) rebuilt in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    phase18_towers(dev, card, bundle)

    # (b) sample_latents with a ViT-B/32 guide: DDIM 20 b1 (a CFG call at
    # UNet batch 2, the guide's UNet call at batch 1 and an f32 decode under
    # grad a step)
    gen = torch.Generator(device=dev).manual_seed(18)
    vit_b = M.CLIPVisionConfig.vit_b32()
    vit_b_params = convert.clip_vision_params(M.init_clip_vision(gen, vit_b, dev), dev)
    text_b = unit_text_embedding(dev, vit_b.projection_dim, 19)
    cg = ClipGuidanceConfig(grad_scale=1.0)
    spec = make_guidance_spec(bundle, PROMPT16)
    cfg = RenderConfig(steps=CG_STEPS, sampler="DDIM", width=512, height=512, seed=18)
    x_T = initial_noise(bundle, cfg, gen)
    plain, _, plain_wall = guided_render(
        f"unguided DDIM {CG_STEPS} b1 (the reference)", card,
        lambda: sample_latents(bundle, spec, cfg, x_init=x_T),
        [(CG_STEPS, ucfg, 64, 2, None)], 0, CG_STEPS, [2] * CG_STEPS)
    guided, paths["clip_guided_ddim20_b1"], wall = guided_render(
        f"CLIP-guided DDIM {CG_STEPS} b1 (ViT-B/32 guide, grad_scale 1)", card,
        lambda: sample_latents(bundle, spec, cfg, x_init=x_T,
                               clip_guidance=(vit_b, vit_b_params, text_b, cg)),
        [(CG_STEPS, ucfg, 64, 2, None), (CG_STEPS, ucfg, 64, 1, None)], CG_STEPS, CG_STEPS,
        [1] * CG_STEPS + [2] * CG_STEPS)
    check_latents(guided, (1, 64, 64, 4))
    moved = rel_rmse(guided, plain)
    print(f"phase18: (b) the guided latents against the unguided render of the same start: "
          f"relRMSE {moved:.4e}; a guided step {wall / CG_STEPS:.4f} s against "
          f"{plain_wall / CG_STEPS:.4f} s unguided ({card})", flush=True)
    if not moved > 0:
        raise SmokeFailure("CLIP guidance left the DDIM latents as they were")
    prompt = CompositionalPrompt(PROMPT16, bundle=bundle)
    prompt.add_conjunction("a red dragon", scale=1.5, mask="left_half_valid")
    n_eval = CG_PLMS_STEPS + 1
    cfg_p = RenderConfig(steps=CG_PLMS_STEPS, sampler="PLMS", width=512, height=512, seed=18)
    spec2 = prompt.build_spec(*cfg_p.latent_shape[:2])
    guided_p, paths["clip_guided_plms10_2factor_b1"], _ = guided_render(
        f"CLIP-guided PLMS {CG_PLMS_STEPS} b1, 2-factor prompt, factor_limit 2", card,
        lambda: sample_latents(bundle, spec2, cfg_p, x_init=x_T,
                               clip_guidance=(vit_b, vit_b_params, text_b,
                                              ClipGuidanceConfig(grad_scale=1.0,
                                                                 factor_limit=2))),
        [(n_eval, ucfg, 64, 3, None), (n_eval, ucfg, 64, 2, None)], n_eval, CG_PLMS_STEPS,
        [2] * n_eval + [3] * n_eval)
    check_latents(guided_p, (1, 64, 64, 4))
    del vit_b_params

    # (c) the standalone CLIP-guided txt2img: ViT-L/14 guide (768 wide, as
    # SD-1.5's pooled text embedding), 4 cutouts a step
    vit_l = M.CLIPVisionConfig.vit_l14()
    vit_l_params = convert.clip_vision_params(M.init_clip_vision(gen, vit_l, dev), dev)
    cfg_c = RenderConfig(steps=CG_STEPS, sampler="DDIM", width=512, height=512, seed=18)
    (images, latents), paths["clip_guided_txt2img_b1"], _ = guided_render(
        f"clip_guided_txt2img DDIM {CG_STEPS} b1 (ViT-L/14 guide, {CG_CUTOUTS} cutouts, the "
        f"pooled SD text embedding)", card,
        lambda: clip_guided_txt2img(bundle, vit_l, vit_l_params, PROMPT16, cfg=cfg_c,
                                    num_cutouts=CG_CUTOUTS, x_T=x_T),
        [(CG_STEPS, ucfg, 64, 2, None), (CG_STEPS, ucfg, 64, 1, None)], CG_STEPS + 1, CG_STEPS,
        [1] * CG_STEPS + [2] * CG_STEPS)
    check_latents(latents, (1, 64, 64, 4))
    check_image(images, (1, 512, 512, 3))
    del vit_l_params

    # (d) a random hypernetwork (k and v, hidden 1536) on every
    # cross-attention site: txt2img b1 DDIM 20, k/v hoisted once
    rng = torch.Generator(device=dev).manual_seed(20)

    def linear(i, o):
        return {"kernel": torch.randn((i, o), generator=rng, device=dev) * i ** -0.5,
                "bias": torch.zeros(o, device=dev)}

    d = ucfg.context_dim
    hyper = {d: {kv: {"linear1": linear(d, HYPER_HIDDEN), "linear2": linear(HYPER_HIDDEN, d)}
                 for kv in ("k", "v")}}
    hbundle = dataclasses.replace(bundle, unet_params=attach_hypernetwork(bundle.unet_params,
                                                                          hyper))
    with ModelCalls("precompute_cross_kv") as hoisted:
        (images, latents), paths["hypernetwork_txt2img_b1"], _ = guided_render(
            f"txt2img with a hypernetwork DDIM {CG_STEPS} b1 (16 sites, k and v, hidden "
            f"{HYPER_HIDDEN})", card,
            lambda: txt2img(hbundle, spec, cfg=cfg, x_T=x_T),
            [(CG_STEPS, ucfg, 64, 2, None)], 1, CG_STEPS, [2] * CG_STEPS)
    check_image(images, (1, 512, 512, 3))
    moved = rel_rmse(latents, plain)
    print(f"phase18: (d) the hypernetwork render against the plain one of the same start: "
          f"relRMSE {moved:.4e}; cross-attention k/v hoisted {hoisted.n} time(s) ({card})",
          flush=True)
    if hoisted.n != 1 or not moved > 0:
        raise SmokeFailure(f"the hypernetwork render: k/v hoisted {hoisted.n} times, moved {moved}")

    # (e) f32 checks at a 16x16 latent against CPU copies of the weights:
    # one CLIP-guided eps (the UNet's eps inside the loss, the f32 decode,
    # the ViT-B/32 guide) and one hypernetwork UNet eval
    cpu = torch.device("cpu")
    b32 = bundle.cast("float32")
    vit_b_params = convert.clip_vision_params(
        M.init_clip_vision(torch.Generator(device=dev).manual_seed(21), vit_b, dev), dev)
    g = torch.Generator().manual_seed(22)
    x16 = torch.randn((1, 16, 16, 4), generator=g)
    e16 = torch.randn((1, 16, 16, 4), generator=g)
    t16 = torch.tensor([601])
    a_t = float(bundle.tables.alphas_cumprod[601])
    cond = spec.factors[:1].clone()

    def guided_eps(device):
        to = (lambda a: a.to(device))
        unet_p = _tree_map(to, b32.unet_params)
        vae_p = _tree_map(to, bundle.vae_params)
        vis_p = _tree_map(to, vit_b_params)

        def eps_in_grad(x_):
            return M.unet_apply(b32.unet_cfg, unet_p, x_, t16.to(device), cond.to(device))

        guide = make_clip_guidance(lambda z: M.vae_decode(bundle.vae_cfg, vae_p, z), vit_b,
                                   vis_p, text_b.to(device), cg, eps_in_grad_fn=eps_in_grad)
        return guide(x16.to(device), e16.to(device), a_t).cpu()

    reset_launches()
    got = guided_eps(dev)
    n = read_launches()
    want = guided_eps(cpu)
    rel = float((got - want).norm() / want.norm())
    moved = float((want - e16).norm() / e16.norm())
    print(f"phase18: (e) one CLIP-guided eps, f32 UNet and f32 VAE (TF32 off) at a 16x16 "
          f"latent, ViT-B/32 guide, CUDA kernels (forward; plain-twin VJPs "
          f"backward) vs the CPU port: rel L2 {rel:.3e} (tol {CG_CPU_TOL:.0e}); the correction "
          f"moves eps by rel {moved:.3e}; launches K1 fused f32 {n['attention_f32_fused_sm90']}, "
          f"K1 3xTF32 {n['attention_f32_sm90']}, K2 f32 {n['geglu_ff_f32_sm90']}, K3 "
          f"{n['group_norm calls']} calls, K4 f32 {n['conv3x3_f32_sm90']} ({card})", flush=True)
    if not rel <= CG_CPU_TOL or not moved > 0 or not n["group_norm calls"] == (
            UNET_GN_CALLS + VAE_DECODE_GN_CALLS):
        raise SmokeFailure(f"the f32 CLIP-guided eps: rel {rel}, moved {moved}, launches {n}")
    del b32
    h32 = hbundle.cast("float32")
    x2 = torch.randn((2, 16, 16, 4), generator=g)
    ctx2 = torch.randn((2, 77, ucfg.context_dim), generator=g)
    t2 = torch.tensor([801, 801])
    with torch.inference_mode():
        got = M.unet_apply(h32.unet_cfg, h32.unet_params, x2.to(dev), t2.to(dev),
                           ctx2.to(dev)).cpu()
        want = M.unet_apply(h32.unet_cfg, _tree_map(lambda a: a.to(cpu), h32.unet_params), x2,
                            t2, ctx2)
        plain = M.unet_apply(h32.unet_cfg, _tree_map(lambda a: a.to(cpu), bundle.cast(
            "float32").unet_params), x2, t2, ctx2)
    rel = float((got - want).norm() / want.norm())
    moved = float((want - plain).norm() / plain.norm())
    print(f"phase18: (e) one f32 UNet eval with the hypernetwork, 16x16 latent b2 (TF32 off), "
          f"CUDA kernels vs the CPU port: rel L2 {rel:.3e} (tol {HYPER_CPU_TOL:.0e}); the "
          f"hypernetwork moves the output by rel {moved:.3e} ({card})", flush=True)
    if not rel <= HYPER_CPU_TOL or not moved > 0:
        raise SmokeFailure(f"the f32 hypernetwork UNet eval: rel {rel}, moved {moved}")
    del bundle, hbundle, h32, vit_b_params
    torch.cuda.empty_cache()
    return paths


ANIM_FRAMES = 4  # frames of phase 19's render_animation
ANIM_STEPS = 20  # its DDIM steps (frame 0 all of them, later frames t_start of them)
ANIM_STRENGTH = 0.5  # its denoising strength: t_start = 10 of 20
FIND_NOISE_STEPS = 20  # phase 19(b): UNet calls of find_noise_for_image (21 sigmas)
VQ_CODES = 16384  # phase 19(c): the VQ codebook
TILED_LATENT = 128  # phase 19(d): a 1024x1024 decode, 64-latent tiles every 48 (9 tiles)
WARP_MIN_EQUAL = 0.999  # phase 19(a): the card's warps against the CPU's on the same inputs


def check_vae_path(launches: dict, what: str, decodes: int, encodes: int, s: int,
                   batch: int = 1) -> None:
    """A bf16 VAE-only path: K3 on its Hopper body for ``decodes`` decodes
    and ``encodes`` encodes, K1's wide body once each at S = ``s`` tokens,
    and no UNet kernel (K1 sm90, K2, K4), f32 body, K5 or probe."""
    check_gn(launches, 0, decodes, encodes, what)
    check_wide(launches, decodes, batch, what, s=s, more=((encodes, batch),))
    others = {n: launches[n] for n in ("attention_sm90", "geglu_ff", "conv3x3",
                                       "attention_f32_sm90", "attention_f32_fused_sm90",
                                       "conv3x3_f32_sm90", "geglu_ff_f32_sm90", "attention_cm")
              + PROBES if launches[n]}
    if others:
        raise SmokeFailure(f"{what} launched kernels off its path: {others}")


def timed(dev, fn):
    """(fn(), seconds) with the device synchronized before and after."""
    import torch

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def phase19_warps_vs_cpu(dev, card: str, frames, keys, args_of) -> None:
    """Each later frame's colour match, 3D and 2D warp on the card against
    the same function on the CPU, each fed the CPU's input: at least
    ``WARP_MIN_EQUAL`` of the values equal and none more than 1 level off."""
    import torch

    from complex_prompt_diffusion_tpu_torch import animation as A

    worst = {}
    for i in range(1, len(frames)):
        args = args_of(i)
        prev, init = torch.from_numpy(frames[i - 1]), torch.from_numpy(frames[0])
        steps = (("match", lambda x: A.match_colors(x, init.to(x.device))),
                 ("warp_3d", lambda x: A.do_3d_animation_step(x, i, keys, args)),
                 ("warp_2d", lambda x: A.do_2d_animation_step(x, i, keys, args)))
        x = prev
        for name, fn in steps:
            cpu = fn(x)
            got = fn(x.to(dev)).cpu()
            d = (got.short() - cpu.short()).abs()
            equal, top = float((d == 0).float().mean()), int(d.max())
            worst[name] = min(worst.get(name, (1.0, 0))[0], equal), max(worst.get(name, (1, 0))[1],
                                                                      top)
            if equal < WARP_MIN_EQUAL or top > 1:
                raise SmokeFailure(f"phase19: frame {i}'s {name} on the card against the CPU: "
                                   f"{equal:.6f} of the values equal, {top} levels at most")
            x = cpu
    print(f"phase19: (a) the card's colour match and warps against the CPU's on the same "
          f"inputs (frames 1-{len(frames) - 1}): worst share equal / max levels "
          + ", ".join(f"{k} {e:.6f} / {m}" for k, (e, m) in worst.items())
          + f" (want >= {WARP_MIN_EQUAL}, <= 1) ({card})", flush=True)


def phase19(dev, card: str) -> dict:
    """Animation, noise inversion, the VQ first stage, the tiled VAE and
    boosted depth at SD-1.5 full width (phase 2's bundle rebuilt from seed
    0: UNet bf16, VAE cast to bf16): (a) ``render_animation`` 512x512 b1,
    ANIM_FRAMES frames of DDIM ANIM_STEPS at strength ANIM_STRENGTH, angle /
    zoom / pan keyframes, the perspective flip on the last frame, a 3D warp
    over the Sobel depth of frame 0; (b) ``find_noise_for_image`` of frame
    0's latents over 21 ascending sigmas at CFG 2; (c) the VQ round trip at
    ``VAEConfig.sd()`` with VQ_CODES codes; (d) ``vae_decode_tiled`` of a
    128x128 latent against the untiled decode; (e) ``boost_depth`` of frame
    0 with the Sobel estimator. Returns the launch counts by path."""
    import numpy as np
    import torch

    from complex_prompt_diffusion_tpu_torch import animation as A
    from complex_prompt_diffusion_tpu_torch import convert
    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch.depth import SobelDepthEstimator, boost_depth
    from complex_prompt_diffusion_tpu_torch.guidance import make_denoiser, stacked_context
    from complex_prompt_diffusion_tpu_torch.noise import find_noise_for_image
    from complex_prompt_diffusion_tpu_torch.pipeline import (
        ModelBundle,
        RenderConfig,
        _sigma_schedule,
        encode_image,
        make_guidance_spec,
    )
    from complex_prompt_diffusion_tpu_torch.prompts import ComplexPrompt

    paths = {}
    t0 = time.perf_counter()
    bundle = ModelBundle.random("sd15", seed=0, device=dev).cast_vae("bfloat16")
    torch.cuda.synchronize()
    ucfg = bundle.unet_cfg
    print(f"phase19: SD-1.5 random bundle of phase 2 (seed 0; UNet bf16, VAE cast to bf16) "
          f"rebuilt in {time.perf_counter() - t0:.2f} s", flush=True)

    # (a) render_animation: the flip switched on for the last frame and the
    # depth map set from frame 0, both by the frame callback (the loop reads
    # the args each frame)
    last = ANIM_FRAMES - 1
    args = A.AnimArgs(w=512, h=512, max_frames=ANIM_FRAMES, angle=f"0: (0), {last}: (6)",
                      zoom=f"0: (1.0), {last}: (1.06)", pan_x=f"0: (0), {last}: (12)",
                      pan_y=f"0: (0), {last}: (-8)", translation_z="0: (25)",
                      rotation_3d_y="0: (1.5)", perspective_flip_theta="0: (5)",
                      perspective_flip_phi="0: (-4)", perspective_flip_fv="0: (50)")
    keys = A.KeyFrames(args)
    depth0 = {}

    def on_frame(i, img):
        if i == 0:
            depth0["map"] = SobelDepthEstimator().estimate(img) * 4.0 + 1.0
            args.depth_map = depth0["map"]
        args.flip_2d_perspective = i + 1 == last

    def args_of(i):
        return dataclasses.replace(args, depth_map=depth0["map"], flip_2d_perspective=i == last)

    cfg = RenderConfig(steps=ANIM_STEPS, sampler="DDIM", width=512, height=512,
                       guidance_scale=7.5, denoising_strength=ANIM_STRENGTH, seed=19)
    prompt = ComplexPrompt(PROMPT16, bundle=bundle)
    t_start = max(1, int((1 - ANIM_STRENGTH) * ANIM_STEPS))
    n_calls = ANIM_STEPS + last * t_start
    timings = []
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    with ModelCalls("unet_apply") as calls:
        frames, wall = timed(dev, lambda: A.render_animation(
            bundle, lambda i: prompt, cfg, args, ANIM_FRAMES, warp_3d=True, coherance=0.98,
            generator=torch.Generator(device=dev).manual_seed(19), frame_callback=on_frame,
            timings=timings))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if calls.batches != [2] * n_calls:
        raise SmokeFailure(f"phase19 (a): UNet calls at batches {calls.batches}, want {n_calls} "
                           f"at 2")
    check_unet_path(launches, ucfg, 2, n_calls, ANIM_FRAMES, last, "phase 19's render_animation")
    for f in frames:
        check_image(f[None], (1, 512, 512, 3))
    paths["render_animation_b1"] = launches
    per = unet_call_launches(ucfg, 64, 2)
    for i, t in enumerate(timings):
        steps = ANIM_STEPS if i == 0 else t_start
        prep = "txt2img (no warp, colour match or encode)" if i == 0 else (
            f"warp {1000 * (t['warp_3d'] + t['warp_2d']):.2f} ms (3D {1000 * t['warp_3d']:.2f}, "
            f"2D {1000 * t['warp_2d']:.2f}{', perspective flip' if i == last else ''}), colour "
            f"match {1000 * t['match']:.2f} ms, encode {1000 * t['encode']:.2f} ms")
        print(f"phase19: (a) frame {i} on {card}: {prep}, {steps} DDIM steps "
              f"{t['sample'] / steps:.4f} s/step, decode {1000 * t['decode']:.2f} ms", flush=True)
    print(f"phase19: (a) render_animation 512x512 b1, {ANIM_FRAMES} frames, DDIM {ANIM_STEPS} "
          f"(later frames t_start {t_start}), CFG 7.5, 2D + 3D warps, on {card}: {wall:.3f} s "
          f"wall, peak memory {peak:.2f} GiB; {calls.n} UNet calls at UNet batch 2 (predicted "
          f"{ANIM_STEPS} + {last} x {t_start}), {ANIM_FRAMES} decodes and {last} encodes (bf16); "
          f"launches K1 sm90 {launches['attention_sm90']} (= {per['k1']} x {n_calls}), K1 wide "
          f"{launches['attention_bf16_wide_sm90']}, K2 {launches['geglu_ff']} (= {per['k2']} x "
          f"{n_calls}), K3 {launches['group_norm']} kernels for {launches['group_norm calls']} "
          f"calls (= {UNET_GN_CALLS} x {n_calls} + {VAE_DECODE_GN_CALLS} x {ANIM_FRAMES} + "
          f"{VAE_ENCODE_GN_CALLS} x {last}), K4 sm90 {launches['conv3x3_sm90']} (= "
          f"{per['k4_sm90']} x {n_calls})", flush=True)
    phase19_warps_vs_cpu(dev, card, frames, keys, args_of)

    # (b) image -> noise: frame 0 encoded, 21 ascending sigmas (the Euler
    # schedule reversed, from 0), CFG 2 at UNet batch 2, k/v hoisted
    spec = make_guidance_spec(bundle, PROMPT16)
    z0 = encode_image(bundle, frames[0])
    sigmas = _sigma_schedule(bundle, RenderConfig(steps=FIND_NOISE_STEPS, sampler="Euler"))[::-1]
    cross_kv = M.precompute_cross_kv(ucfg, bundle.unet_params, stacked_context(spec, 1))
    _, den_fn = make_denoiser(
        lambda x, t, c: M.unet_apply(ucfg, bundle.unet_params, x, t, c, cross_kv=cross_kv),
        spec, model_sigmas=bundle.tables.sigmas)
    reset_launches()
    with ModelCalls("unet_apply") as calls:
        x_n, wall = timed(dev, lambda: find_noise_for_image(den_fn, z0, sigmas, 2.0))
    launches = read_launches()
    check_latents(x_n, (1, 64, 64, 4))
    if calls.batches != [2] * FIND_NOISE_STEPS:
        raise SmokeFailure(f"phase19 (b): UNet calls at batches {calls.batches}, want "
                           f"{FIND_NOISE_STEPS} at 2")
    check_unet_path(launches, ucfg, 2, FIND_NOISE_STEPS, 0, 0, "phase 19's find_noise_for_image")
    paths["find_noise_for_image_b1"] = launches
    print(f"phase19: (b) find_noise_for_image of frame 0's latents, {len(sigmas)} sigmas "
          f"{float(sigmas[0]):.3g} -> {float(sigmas[-1]):.4g}, CFG 2, on {card}: "
          f"{calls.n} UNet calls (= NFE {len(sigmas) - 1}) at UNet batch 2, "
          f"{wall / calls.n:.4f} s a call, {wall:.3f} s wall; the noise's std "
          f"{float(x_n.std()):.3f} (sigma_max {float(sigmas[-1]):.3f})", flush=True)

    # (c) the VQ round trip: SD's autoencoder widths, VQ_CODES codes, bf16
    vq_cfg = dataclasses.replace(M.VAEConfig.sd(), dtype="bfloat16")
    vq = convert.vae_params(M.init_vq_model(torch.Generator(device=dev).manual_seed(20),
                                            M.VAEConfig.sd(), VQ_CODES, dev),
                            dev, torch.bfloat16)
    x = torch.as_tensor(frames[0], device=dev)[None].float() / 127.5 - 1.0
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode():
        h, t_enc = timed(dev, lambda: M.vq_encode(vq_cfg, vq, x, quantize=False))
        (z_q, loss, idx), t_q = timed(dev, lambda: M.vq_quantize(vq["quantize"], h))
        out, t_dec = timed(dev, lambda: M.vq_decode(vq_cfg, vq, z_q))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    in_range = float(((idx >= 0) & (idx < VQ_CODES)).float().mean())
    if tuple(out.shape) != (1, 512, 512, 3) or not bool(torch.isfinite(out).all()) \
            or in_range != 1.0 or not bool(torch.isfinite(loss)):
        raise SmokeFailure(f"phase19 (c): VQ output {tuple(out.shape)}, codes in range "
                           f"{in_range}, loss {float(loss)}")
    check_vae_path(launches, "phase 19's VQ round trip", 1, 1, 4096)
    paths["vq_round_trip_b1"] = launches
    print(f"phase19: (c) VQ round trip 512x512 b1 (VAEConfig.sd(), {VQ_CODES} codes, bf16 "
          f"autoencoder, f32 distances) on {card}: encode {1000 * t_enc:.2f} ms, quantize "
          f"{1000 * t_q:.2f} ms, decode {1000 * t_dec:.2f} ms, peak memory {peak:.2f} GiB; "
          f"codes in range {100 * in_range:.1f}% ({int(idx.unique().numel())} distinct), loss "
          f"{float(loss):.4g}", flush=True)
    del vq, h, z_q, out

    # (d) the tiled decode of a 1024x1024 canvas against the untiled one
    from complex_prompt_diffusion_tpu_torch.models.vae import _tile_starts

    side = 8 * TILED_LATENT
    n_tiles = len(_tile_starts(TILED_LATENT, 64, 48)) ** 2
    z = torch.randn((1, TILED_LATENT, TILED_LATENT, 4),
                    generator=torch.Generator(device=dev).manual_seed(21), device=dev)
    vcfg, vparams = bundle.vae_cfg, bundle.vae_params
    rows = {}
    for label, fn, decodes, s in (
            ("tiled", lambda: M.vae_decode_tiled(vcfg, vparams, z, tile=64, overlap=16), n_tiles,
             4096),
            ("untiled", lambda: M.vae_decode(vcfg, vparams, z), 1, TILED_LATENT**2)):
        reset_launches()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        with torch.inference_mode():
            img, sec = timed(dev, fn)
        launches = read_launches()
        check_vae_path(launches, f"phase 19's {label} {side}x{side} decode", decodes, 0, s)
        paths[f"vae_decode_{side}_{label}"] = launches
        rows[label] = (img, sec, torch.cuda.max_memory_allocated(dev) / 2**30)
    (a_img, a_s, a_peak), (b_img, b_s, b_peak) = rows["tiled"], rows["untiled"]
    if tuple(a_img.shape) != (1, side, side, 3) or not bool(torch.isfinite(a_img).all()):
        raise SmokeFailure(f"phase19 (d): tiled decode {tuple(a_img.shape)} or not finite")
    a01, b01 = (a_img.clamp(-1, 1) + 1) / 2, (b_img.clamp(-1, 1) + 1) / 2
    diff = (a01 - b01).abs()
    mse = float(diff.pow(2).mean())
    psnr = 10 * np.log10(1.0 / mse) if mse > 0 else float("inf")
    print(f"phase19: (d) vae_decode_tiled {TILED_LATENT}x{TILED_LATENT} latent -> {side}x{side} "
          f"(tile 64, overlap 16: {n_tiles} tiles, bf16) on {card}: {1000 * a_s:.2f} ms, peak "
          f"memory {a_peak:.2f} GiB; untiled {1000 * b_s:.2f} ms, peak memory {b_peak:.2f} GiB "
          f"(first calls of each); tiled against untiled on [0, 1]: max abs "
          f"{float(diff.max()):.4f}, PSNR {psnr:.2f} dB (reported: tiling changes the result)",
          flush=True)
    del rows, a_img, b_img, a01, b01, diff

    # (e) boosted depth of frame 0 (host numpy and CPU resizes)
    t0 = time.perf_counter()
    boosted = boost_depth(frames[0], SobelDepthEstimator(), base_size=128)
    sec = time.perf_counter() - t0
    if boosted.shape != (512, 512) or not np.isfinite(boosted).all():
        raise SmokeFailure(f"phase19 (e): boost_depth gave {boosted.shape}")
    print(f"phase19: (e) boost_depth of frame 0 (512x512, Sobel estimator, base 128, up to 16 "
          f"patches) on the card's host: {sec:.2f} s wall, range [{boosted.min():.3f}, "
          f"{boosted.max():.3f}] ({card})", flush=True)
    del bundle
    torch.cuda.empty_cache()
    return paths


SUBPIXEL_REPS = 5  # phase 21(a): timed calls of each form, after one warm-up call
# phase 21(a): relRMSE of the forced subpixel form against the conv of the
# upsampled plane: bf16 (the summed taps rounded to bf16 once, each form's
# bf16 rounding carried through the layers after it) and f32 (TF32 off:
# only the order of f32 sums differs)
SUBPIXEL_TOL = {"bfloat16": 5e-2, "float32": 1e-4}
CLF_STEPS = 5  # phase 21(b): DPM-Solver++ 2M steps of the classifier-guided sample
CLF_SCALE = 2.0  # its guidance scale
CLF_TOL = 1e-4  # one f32 guided eps on the card against the CPU (TF32 off; 3xTF32 bodies)
# the guidance term (scale x sigma x the classifier's gradient) and the
# 5-step sample against the CPU: the gradient is the plain VJP's on the card,
# of inputs the kernels computed (3xTF32, ~1e-6 of each layer's scale)
CLF_GRAD_TOL = 1e-3


@contextlib.contextmanager
def subpixel_forced():
    """Forces the exact subpixel upsample conv (``models.layers.
    _SUBPIXEL_UP = "1"``) inside the block and restores the flag after."""
    from complex_prompt_diffusion_tpu_torch.models import layers as L

    flag = L._SUBPIXEL_UP
    L._SUBPIXEL_UP = "1"
    try:
        yield
    finally:
        L._SUBPIXEL_UP = flag


def event_ms(fn, reps: int) -> float:
    """Mean ms of ``reps`` calls of ``fn`` by CUDA events, after one call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase21_subpixel(bundle, dev, card: str) -> dict:
    """(a) The exact subpixel upsample conv (``layers.conv3x3_after_upsample2x``,
    which the JAX package takes by default on a TPU and the port only when
    forced) against the conv of the upsampled plane: one SD-1.5 UNet call
    in bf16 at UNet batch 2 (its three "up" convs), the b1 decode in bf16
    and in f32 (its three upsamplers): relRMSE of forced against off, the
    ms of each form (CUDA events), the forced call's launches (K4 without
    the two up convs inside its gate, which the subpixel form takes as
    matmuls)."""
    import torch

    from complex_prompt_diffusion_tpu_torch import models as M

    gen = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn((2, 64, 64, 4), generator=gen, device=dev)
    t = torch.tensor([801, 801], device=dev)
    ctx = torch.randn((2, 77, 768), generator=gen, device=dev)
    z = torch.randn((1, 64, 64, 4), generator=gen, device=dev)
    vae16 = bundle.cast_vae("bfloat16")
    ucfg = bundle.unet_cfg
    calls = (
        ("UNet call bf16 UNet batch 2", "bfloat16",
         lambda: M.unet_apply(ucfg, bundle.unet_params, x, t, ctx),
         lambda n: check_calls(n, "the UNet call with the subpixel up convs",
                               [(1, ucfg, 64, 2, None)])),
        ("b1 decode bf16", "bfloat16", lambda: M.vae_decode(vae16.vae_cfg, vae16.vae_params, z),
         lambda n: check_vae_path(n, "the bf16 decode with the subpixel upsamplers", 1, 0, 4096)),
        ("b1 decode f32", "float32", lambda: M.vae_decode(bundle.vae_cfg, bundle.vae_params, z),
         lambda n: check_gn(n, 0, 1, 0, "the f32 decode with the subpixel upsamplers")),
    )
    paths = {}
    with torch.inference_mode():
        for label, dtype, fn, check in calls:
            off = fn()
            off_ms = event_ms(fn, SUBPIXEL_REPS)
            with subpixel_forced():
                reset_launches()
                on = fn()
                torch.cuda.synchronize()
                launches = read_launches()
                check(launches)
                on_ms = event_ms(fn, SUBPIXEL_REPS)
            rel = rel_rmse(on, off)
            print(f"phase21: (a) {label}, subpixel upsample conv forced against off: relRMSE "
                  f"{rel:.3e} (tol {SUBPIXEL_TOL[dtype]:.0e}), forced {on_ms:.3f} ms, off "
                  f"{off_ms:.3f} ms (mean of {SUBPIXEL_REPS}, CUDA events; {card})", flush=True)
            if not (rel <= SUBPIXEL_TOL[dtype] and bool(torch.isfinite(on).all())):
                raise SmokeFailure(f"the subpixel form of the {label}: relRMSE {rel:.3e}")
            paths[f"subpixel_{label.replace(' ', '_')}"] = launches
    return paths


def classifier_params(dev) -> dict:
    """Phase 21(b)'s classifier: a 3x3 conv 4 -> 320, GroupNorm + SiLU, a
    3x3 conv 320 -> 320 and self-attention over the 256 pixels of a 16x16
    latent (8 heads of 40), in the port's layout, f32, from a seed."""
    import torch

    from complex_prompt_diffusion_tpu_torch import convert
    from complex_prompt_diffusion_tpu_torch.models import layers as L

    gen = torch.Generator().manual_seed(211)
    tree = {"conv_in": L.init_conv(gen, 4, 320, 3), "norm": L.init_group_norm(320),
            "conv": L.init_conv(gen, 320, 320, 3)}
    for conv in (tree["conv_in"], tree["conv"]):
        conv["bias"] = torch.rand(conv["bias"].shape, generator=gen) * 0.2 - 0.1
    tree["norm"]["scale"] = 1 + 0.1 * torch.randn(320, generator=gen)
    return convert.to_port(tree, device=dev)


def classifier_guided_sample(unet_cfg, unet_params, clf, ns, x, ctx):
    """DPM-Solver++ 2M over ``CLF_STEPS`` steps of the classifier-guided eps
    (``model_wrapper(guidance_type="classifier")``: the UNet's eps at the
    context ``ctx`` minus scale x sigma x the gradient of the classifier's
    log-probability), and one guided eps and the unguided one at t = 0.5.
    Returns (sample, guided eps, unguided eps, classifier calls)."""
    import torch

    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch.models import layers as L
    from complex_prompt_diffusion_tpu_torch.ops import attention
    from complex_prompt_diffusion_tpu_torch.samplers.solver import model_wrapper, sample_dpm_solver

    calls = []

    def model(x_, t_in, cond):
        t_ = torch.full((x_.shape[0],), float(t_in), device=x_.device)
        return M.unet_apply(unet_cfg, unet_params, x_, t_, ctx)

    def classifier(x_, t_in, cond):
        calls.append(1)
        h = L.group_norm_silu_p(clf["norm"], L.conv2d(clf["conv_in"], x_))
        s = L.conv2d(clf["conv"], h).reshape(x_.shape[0], -1, 320)
        return attention(s, s, s, 8).mean(dim=(1, 2)) * cond * (1.0 + float(t_in) / 1000.0)

    cond = torch.tensor(3.0, device=x.device)
    guided = model_wrapper(model, ns, guidance_type="classifier", guidance_scale=CLF_SCALE,
                           classifier_fn=classifier, condition=cond)
    plain = model_wrapper(model, ns, condition=cond)
    with torch.no_grad():
        eps_g, eps_u = guided(x, 0.5), plain(x, 0.5)
        sample = sample_dpm_solver(guided, x, ns, steps=CLF_STEPS, order=2)
    return sample, eps_g, eps_u, len(calls)


def phase21_classifier(bundle, dev, card: str) -> dict:
    """(b) DPM-Solver classifier guidance (the JAX package's ``model_wrapper``
    with ``guidance_type="classifier"``) on a 16x16 latent: the SD-1.5 UNet
    cast to f32 and a classifier that runs K4 (its narrow-C body on the
    4-channel conv, its 3xTF32 body on 320 -> 320), K3 and K1 (the fused
    3xTF32 body) forward, its gradient through their plain VJP rules; one
    guided eps, its guidance term and a 5-step DPM-Solver++ 2M sample against
    the same on CPU copies (TF32 off), the card's launches as the UNet calls
    and the classifier's layers predict and no kernel in the backward."""
    import torch

    from complex_prompt_diffusion_tpu_torch.pipeline import _tree_map
    from complex_prompt_diffusion_tpu_torch.samplers.solver import NoiseScheduleVP

    b32 = bundle.cast("float32")
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(212)
    x = torch.randn((1, 16, 16, 4), generator=gen)
    ctx = torch.randn((1, 77, 768), generator=gen)
    ns = NoiseScheduleVP("discrete", alphas_cumprod=bundle.tables.alphas_cumprod)
    reset_launches()
    t0 = time.perf_counter()
    got = classifier_guided_sample(b32.unet_cfg, b32.unet_params, classifier_params(dev), ns,
                                   x.to(dev), ctx.to(dev))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    got = [g.cpu() if isinstance(g, torch.Tensor) else g for g in got]
    want = classifier_guided_sample(b32.unet_cfg, _tree_map(lambda a: a.to(cpu), b32.unet_params),
                                    classifier_params(cpu), ns, x, ctx)
    del b32
    evals = CLF_STEPS + 2  # the guided and unguided evals at t = 0.5, then the sample's
    per = unet_call_launches(bundle.unet_cfg, 16, 1, "float32")
    clf_calls = got[3]
    want_n = {"attention": evals * per["k1"] + clf_calls,
              "conv3x3": evals * per["k4"] + 2 * clf_calls,
              "group_norm calls": evals * UNET_GN_CALLS + clf_calls, "group_norm_cat": 0}
    n = {k: launches[k] for k in want_n}
    eps_rel = rel_err(got[1], want[1])[1]
    term_rel = rel_err(got[1] - got[2], want[1] - want[2])[1]
    sample_rel = rel_rmse(got[0], want[0])
    ok = (n == want_n and clf_calls == want[3] == CLF_STEPS + 1 and eps_rel <= CLF_TOL
          and term_rel <= CLF_GRAD_TOL and sample_rel <= CLF_GRAD_TOL
          and launches["group_norm"] == launches["group_norm planned"])
    print(f"phase21: (b) DPM-Solver++ 2M {CLF_STEPS} steps, classifier guidance (scale "
          f"{CLF_SCALE}) on a 16x16 latent, SD-1.5 UNet f32 + a K4/K3/K1 classifier, on {card}: "
          f"{secs:.3f} s; guided eps vs CPU rel {eps_rel:.3e} (tol {CLF_TOL:.0e}), guidance "
          f"term rel {term_rel:.3e} and sample relRMSE {sample_rel:.3e} (tol "
          f"{CLF_GRAD_TOL:.0e}); {clf_calls} classifier gradients; launches {n} (want "
          f"{want_n}: {evals} UNet calls, the classifier's forwards, nothing in the backwards)",
          flush=True)
    if not ok:
        raise SmokeFailure(f"phase21 (b): classifier guidance: launches {n} (want {want_n}), "
                           f"{clf_calls} classifier calls, rel {eps_rel:.3e} / {term_rel:.3e} / "
                           f"{sample_rel:.3e}")
    return {"dpm_solver_classifier_guidance": launches}


def phase21(bundle, dev, card: str) -> dict:
    """The JAX package's last forms on the card: (a) the exact subpixel
    upsample conv, forced, against off; (b) DPM-Solver classifier
    guidance against its CPU twin."""
    paths = phase21_subpixel(bundle, dev, card)
    paths.update(phase21_classifier(bundle, dev, card))
    return paths


DIFF_STEPS = 20  # DDIM steps of phase 20's diffusers-keyed and CompVis-keyed renders
RANK_STEPS = 10  # DDIM steps of its tensor- and data-parallel renders
TP_SD15_ALL_REDUCES = 48  # all-reduces of a tensor-parallel SD-1.5 UNet call: 3 x 16 blocks
RANK_EVAL_TOL = 2e-2  # one bf16 TP UNet eval against the one-rank eval: max |a - b| / max |b|
RANK_F32_TOL = 1e-4  # the same eval in f32 (TF32 off, biases drawn nonzero): max |a - b| / max |b|
RANK_RENDER_TOL = 0.1  # relRMSE of the bf16 TP render's latents against the one-rank ones
T5_TOL = 1e-4  # the T5 encoder's row on the card against the CPU port (f32, TF32 off)
KL_TOL = 1e-5  # kl / nll on the card against the CPU on the same moments (relative)


def phase20_rank(rank: int, n: int, tmp: str, backend: str) -> None:
    """One of phase 20's ``n`` ranks (``file://`` rendezvous in ``tmp``):
    under gloo every rank on cuda:0 (NCCL refuses two ranks on one device),
    under NCCL a card a rank. Runs :func:`phase20_rank_paths` and writes
    what it found to ``tmp/rank<r>.json`` for the parent. An error ends the
    process non-zero, which fails the parent's spawn."""
    import torch
    import torch.distributed as dist

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=n)
    try:
        out = phase20_rank_paths(rank, n, dev)
    finally:
        dist.destroy_process_group()
    with open(f"{tmp}/rank{rank}.json", "w") as f:
        json.dump(out, f)


def with_biases(params, dev, seed: int):
    """``params`` with every ``bias`` leaf drawn from N(0, 0.02^2) (a
    generator on ``dev`` seeded with ``seed``, so every rank draws the
    same): the init's zero biases would hide a bias added on every rank."""
    import torch

    from complex_prompt_diffusion_tpu_torch.parallel.mesh import tree_map_with_path

    gen = torch.Generator(device=dev).manual_seed(seed)
    return tree_map_with_path(
        lambda path, a: (0.02 * torch.randn(a.shape, generator=gen, device=dev)).to(a.dtype)
        if path[-1] == "bias" else a, params)


def phase20_rank_paths(rank: int, n: int, dev) -> dict:
    """A rank's share of phase 20 (d) on ``n`` ranks: rank 0 builds phase
    2's SD-1.5 bundle (bf16 VAE) and ``replicate`` broadcasts it; then (TP)
    ``shard_bundle`` over model n: one bf16 UNet eval against the
    unsharded eval (RANK_EVAL_TOL), the same eval in f32 with the biases
    drawn nonzero against the unsharded f32 eval (RANK_F32_TOL: a wrong
    shard, a bias added on every rank or value and gate columns swapped,
    moves it by far more), and txt2img 512x512 b1 DDIM RANK_STEPS against
    the one-rank render of the same weights and x_T, the launches and
    all-reduces of every UNet call; (DP) data n: the rank's image of a bn
    txt2img (``shard_batch``), no all-reduce in a UNet call, torch.equal
    to the one-rank b1 render of its x_T slice (the same shapes and
    kernels), the gathered latents (``gather_batch``) equal to the gathered
    one-rank renders; rank 0 times the one-rank bn render."""
    import numpy as np
    import torch

    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch.guidance import stacked_context
    from complex_prompt_diffusion_tpu_torch.parallel import (
        gather_batch,
        make_mesh,
        replicate,
        shard_batch,
    )
    from complex_prompt_diffusion_tpu_torch.parallel.tp import shard_bundle
    from complex_prompt_diffusion_tpu_torch.pipeline import (
        ModelBundle,
        RenderConfig,
        decode_latents,
        make_guidance_spec,
        txt2img,
    )

    out = {}
    t0 = time.perf_counter()
    b = ModelBundle.random("sd15", seed=0, device=dev).cast_vae("bfloat16") if rank == 0 else None
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    b = replicate(make_mesh(), b, device=dev)
    torch.cuda.synchronize()
    out["build_s"], out["replicate_s"] = t1 - t0, time.perf_counter() - t1
    ucfg = b.unet_cfg
    gen = torch.Generator(device=dev)
    cfg = RenderConfig(steps=RANK_STEPS, width=512, height=512, batch_size=1,
                       guidance_scale=7.5, seed=25)

    def render(bundle, cfg, x_T):
        """txt2img's latents, its launches, its UNet calls' batches and
        all-reduces."""
        counts, batches = [], []
        inner = M.unet_apply

        def counted(c, p, x, *a, **kw):
            shard = kw.get("shard")
            before = shard.all_reduces if shard is not None else 0
            res = inner(c, p, x, *a, **kw)
            batches.append(int(x.shape[0]))
            counts.append((shard.all_reduces if shard is not None else 0) - before)
            return res

        reset_launches()
        M.unet_apply = counted
        try:
            (_, lat), sec = timed(dev, lambda: txt2img(bundle, PROMPT16, cfg=cfg, x_T=x_T,
                                                       decode=False))
        finally:
            M.unet_apply = inner
        return lat, read_launches(), batches, counts, sec

    # (TP) model n
    tmesh = make_mesh(model=n)
    tb = shard_bundle(b, tmesh)
    x_T = torch.randn((1, 64, 64, 4), generator=gen.manual_seed(25), device=dev)
    spec = make_guidance_spec(b, PROMPT16)
    x2 = torch.cat([x_T, x_T])
    t = torch.full((2,), 981, device=dev)
    ctx = stacked_context(spec, 1)
    with torch.inference_mode():
        tb.shard.all_reduces = 0
        e_tp = M.unet_apply(ucfg, tb.unet_params, x2, t, ctx, shard=tb.shard)
        e_one = M.unet_apply(ucfg, b.unet_params, x2, t, ctx)
        out["eval_all_reduces"] = tb.shard.all_reduces
        out["eval"] = list(rel_err(e_tp, e_one))
        del e_tp, e_one
        b32 = b.cast("float32")
        b32 = dataclasses.replace(b32, unet_params=with_biases(b32.unet_params, dev, 28))
        t32 = shard_bundle(b32, tmesh)
        e_tp = M.unet_apply(b32.unet_cfg, t32.unet_params, x2, t, ctx, shard=t32.shard)
        e_one = M.unet_apply(b32.unet_cfg, b32.unet_params, x2, t, ctx)
        out["eval_f32"] = list(rel_err(e_tp, e_one))
    del b32, t32, e_tp, e_one
    torch.cuda.empty_cache()
    lat, launches, batches, counts, sec = render(tb, cfg, x_T)
    if batches != [2] * RANK_STEPS or counts != [TP_SD15_ALL_REDUCES] * RANK_STEPS:
        raise SmokeFailure(f"rank {rank}'s TP render: UNet calls at batches {batches} with "
                           f"all-reduces {counts}; want {RANK_STEPS} at batch 2 with "
                           f"{TP_SD15_ALL_REDUCES} each")
    check_unet_path(launches, ucfg, 2, RANK_STEPS, 0, 0, f"rank {rank}'s tensor-parallel render",
                    model=n)
    check_latents(lat, (1, 64, 64, 4))
    ref, _, _, _, ref_sec = render(b, cfg, x_T)
    out["tp"] = {"launches": launches, "s": sec, "one_rank_s": ref_sec,
                 "rel_rmse": rel_rmse(lat, ref), "max_abs": float((lat - ref).abs().max()),
                 "all_reduces": counts[0], "k2_per_call": unet_call_launches(ucfg, 64, 2,
                                                                            model=n)["k2"]}
    if (out["eval"][1] > RANK_EVAL_TOL or out["eval_f32"][1] > RANK_F32_TOL
            or out["tp"]["rel_rmse"] > RANK_RENDER_TOL):
        raise SmokeFailure(f"rank {rank}'s TP UNet eval (bf16 rel {out['eval'][1]:.3e}, tol "
                           f"{RANK_EVAL_TOL}; f32 rel {out['eval_f32'][1]:.3e}, tol "
                           f"{RANK_F32_TOL}) or render (relRMSE {out['tp']['rel_rmse']:.3e}, "
                           f"tol {RANK_RENDER_TOL}) against one rank")
    del tb
    torch.cuda.empty_cache()

    # (DP) data n: the bn render, one image a rank
    dmesh = make_mesh(data=n)
    db = shard_bundle(b, dmesh)
    x_full = torch.randn((n, 64, 64, 4), generator=gen.manual_seed(26), device=dev)
    x_mine = shard_batch(dmesh, x_full)
    lat, launches, batches, counts, sec = render(db, cfg, x_mine)
    if batches != [2] * RANK_STEPS or set(counts) != {0}:
        raise SmokeFailure(f"rank {rank}'s DP render: UNet calls at batches {batches} with "
                           f"all-reduces {counts}; want {RANK_STEPS} at batch 2, none")
    check_unet_path(launches, ucfg, 2, RANK_STEPS, 0, 0, f"rank {rank}'s data-parallel render")
    t2 = time.perf_counter()
    lat_all = gather_batch(dmesh, lat)
    torch.cuda.synchronize()
    gather_s = time.perf_counter() - t2
    ref, _, _, _, _ = render(b, cfg, x_mine)
    ref_all = gather_batch(dmesh, ref)
    img = decode_latents(b, lat)
    check_image(img, (1, 512, 512, 3))
    out["dp"] = {"launches": launches, "s": sec, "gather_s": gather_s,
                 "equal": bool(torch.equal(lat, ref)),
                 "gathered_equal": bool(torch.equal(lat_all, ref_all))}
    if rank == 0:
        _, _, _, _, out["dp"]["one_rank_bn_s"] = render(
            b, dataclasses.replace(cfg, batch_size=n), x_full)
    if not (out["dp"]["equal"] and out["dp"]["gathered_equal"]):
        raise SmokeFailure(f"rank {rank}'s DP render differs from the one-rank b1 render of its "
                           f"x_T slice (max |d| {float((lat - ref).abs().max()):.3e}; gathered "
                           f"equal: {out['dp']['gathered_equal']})")
    return out


def phase20_ranks(n: int, backend: str, card: str) -> dict:
    """Spawn :func:`phase20_rank` on ``n`` ranks and print what each found;
    returns the launch counts of each rank's TP and DP renders by path."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    paths = {}
    tmp = tempfile.mkdtemp(prefix="ranks-")
    t0 = time.perf_counter()
    try:
        mp.start_processes(phase20_rank, args=(n, tmp, backend), nprocs=n, join=True,
                           start_method="spawn")
        ranks = []
        for r in range(n):
            with open(f"{tmp}/rank{r}.json") as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t0
    where = "cuda:0" if backend == "gloo" else f"{n} cards"
    for r, res in enumerate(ranks):
        tp, dp = res["tp"], res["dp"]
        paths[f"tp{n}_rank{r}_txt2img_b1"] = tp["launches"]
        paths[f"dp{n}_rank{r}_txt2img_b{n}"] = dp["launches"]
        print(f"phase20: (d) rank {r} of {n} on {where} ({backend}; SD-1.5 built by rank 0 in "
              f"{res['build_s']:.2f} s, replicated in {res['replicate_s']:.2f} s): TP model {n}: "
              f"one UNet eval at UNet batch 2 against one rank: bf16 rel {res['eval'][1]:.3e} "
              f"(tol {RANK_EVAL_TOL}), f32 with nonzero biases rel {res['eval_f32'][1]:.3e} "
              f"(max |d| {res['eval_f32'][0]:.3e}, tol {RANK_F32_TOL}), "
              f"{res['eval_all_reduces']} all-reduces; txt2img 512x512 b1 DDIM {RANK_STEPS} "
              f"{tp['s'] / RANK_STEPS:.4f} s/step (one rank {tp['one_rank_s'] / RANK_STEPS:.4f}), "
              f"latents relRMSE {tp['rel_rmse']:.3e} max |d| {tp['max_abs']:.3e} (tol "
              f"{RANK_RENDER_TOL}), {tp['all_reduces']} all-reduces a UNet call, launches K1 sm90 "
              f"{tp['launches']['attention_sm90']} ({8 // n} heads a site), K2 "
              f"{tp['launches']['geglu_ff']} (= {tp['k2_per_call']} x {RANK_STEPS} at 1/{n} of "
              f"the hidden width), K3 {tp['launches']['group_norm']}, K4 sm90 "
              f"{tp['launches']['conv3x3_sm90']} (as predicted) ({card})", flush=True)
        one = (f" (one rank, the whole b{n}: {dp['one_rank_bn_s'] / RANK_STEPS:.4f})"
               if "one_rank_bn_s" in dp else "")
        print(f"phase20: (d) rank {r}: DP data {n}: its image of a b{n} txt2img DDIM "
              f"{RANK_STEPS} {dp['s'] / RANK_STEPS:.4f} s/step{one}, no all-reduce; torch.equal "
              f"to the one-rank b1 render of its x_T slice, and the latents gathered "
              f"({'via the host ' if backend == 'gloo' else ''}in "
              f"{1000 * dp['gather_s']:.2f} ms) to the gathered one-rank renders ({card})",
              flush=True)
    print(f"phase20: (d) the {n} ranks took {wall:.1f} s wall (spawn included) ({card})",
          flush=True)
    return paths


def phase20(dev, card: str) -> dict:
    """The port's last modules at SD-1.5 full width (after phase 19): (a) a
    random SD-1.5 UNet written as a diffusers state dict (fp16,
    ``synth_checkpoint``), read by ``convert_unet_diffusers``, against the
    same tree written under CompVis keys and read by ``convert_unet``: the
    trees bit-equal, and txt2img 512x512 b1 DDIM DIFF_STEPS (bf16 VAE
    decode) torch.equal between the two routes, K1-K4 launches as
    predicted; (b) ``T5Config.v1_1_large`` (random weights, f32) over [4,
    77] tokens, one row against the CPU port, and ``clip_t5_encode`` with
    SD-1.5's CLIP; (c) ``kl`` / ``nll`` of the bf16 encoder's posterior of
    (a)'s image against the CPU on the same moments; (d) two ranks on
    cuda:0 (:func:`phase20_rank`), tensor-parallel at model 2 and
    data-parallel at data 2. Returns the launch counts by path, the ranks'
    too."""
    import torch

    from complex_prompt_diffusion_tpu_torch import convert
    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch.models import embedders as E
    from complex_prompt_diffusion_tpu_torch.models import params as PR
    from complex_prompt_diffusion_tpu_torch.pipeline import (
        ModelBundle,
        RenderConfig,
        _tree_map,
        _unzero_kernels,
        decode_latents,
        txt2img,
    )
    from complex_prompt_diffusion_tpu_torch.tools import synth_checkpoint as SC
    from complex_prompt_diffusion_tpu_torch.train.optimizers import tree_leaves

    paths = {}
    t_phase = time.perf_counter()
    base = ModelBundle.random("sd15", seed=0, device=dev).cast_vae("bfloat16")
    ucfg = base.unet_cfg

    # (a) the diffusers layout against the CompVis one
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(22)
    tree = _unzero_kernels(gen, M.init_unet(gen, ucfg, dev))
    routes = {}
    for route, write, read in (
            ("diffusers", SC.diffusers_unet_state_dict, PR.convert_unet_diffusers),
            ("CompVis", SC.compvis_unet_state_dict,
             lambda c, sd: PR.convert_unet(c, sd, prefix="model.diffusion_model."))):
        sd = {k: v.numpy() for k, v in write(ucfg, tree, dtype=torch.float16).items()}
        routes[route] = (len(sd), convert.unet_params(read(ucfg, sd), dev, torch.bfloat16))
        del sd
    del tree
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    bad = tree_mismatches(routes["diffusers"][1], routes["CompVis"][1])
    if bad:
        raise SmokeFailure(f"phase20 (a): the diffusers route's UNet tree differs from the "
                           f"CompVis route's at {bad[:5]} ({len(bad)} leaves)")
    cfg = RenderConfig(steps=DIFF_STEPS, width=512, height=512, batch_size=1,
                       guidance_scale=7.5, seed=23)
    lats = {}
    for route, (n_keys, params) in routes.items():
        bundle = dataclasses.replace(base, unet_params=params)
        reset_launches()
        with ModelCalls("unet_apply") as calls:
            (_, lat), sec = timed(dev, lambda: txt2img(bundle, PROMPT16, cfg=cfg, decode=False))
        images = decode_latents(bundle, lat)
        launches = read_launches()
        if calls.batches != [2] * DIFF_STEPS:
            raise SmokeFailure(f"phase20 (a) {route}: UNet calls at batches {calls.batches}")
        check_unet_path(launches, ucfg, 2, DIFF_STEPS, 1, 0, f"phase 20's {route}-keyed render")
        check_image(images, (1, 512, 512, 3))
        lats[route] = lat
        paths[f"{route.lower()}_keyed_txt2img_b1"] = launches
        print(f"phase20: (a) {route}-keyed SD-1.5 UNet ({n_keys} fp16 tensors) -> bundle, "
              f"txt2img 512x512 b1 DDIM {DIFF_STEPS} + bf16 decode on {card}: "
              f"{sec / DIFF_STEPS:.4f} s/step; launches K1 sm90 {launches['attention_sm90']}, K2 "
              f"{launches['geglu_ff']}, K3 {launches['group_norm']}, K4 sm90 "
              f"{launches['conv3x3_sm90']} (as predicted)", flush=True)
        if route == "diffusers":
            image = images[0]
    if not torch.equal(lats["diffusers"], lats["CompVis"]):
        raise SmokeFailure("phase20 (a): the diffusers-keyed render's latents differ from the "
                           "CompVis-keyed render's")
    print(f"phase20: (a) both trees bit-equal (written and converted in {convert_s:.2f} s) and "
          f"the two renders' latents torch.equal ({card})", flush=True)
    del routes, lats

    # (b) T5 v1.1-large and the CLIP + T5 pair
    t5cfg = E.T5Config.v1_1_large()
    gen.manual_seed(24)
    t5 = E.init_t5_encoder(gen, t5cfg, dev)
    tokens = torch.randint(0, t5cfg.vocab_size, (4, 77), generator=gen, device=dev)
    reset_launches()
    with torch.inference_mode():
        enc, first_s = timed(dev, lambda: E.t5_encode(t5cfg, t5, tokens))
        enc, sec = timed(dev, lambda: E.t5_encode(t5cfg, t5, tokens))
        clip_tokens = torch.as_tensor(base.tokenizer([PROMPT16, "a red cube", "", "a cat"]),
                                      device=dev)
        pair = E.clip_t5_encode(
            lambda t: M.clip_text_apply(base.clip_cfg, base.clip_params, t),
            lambda t: E.t5_encode(t5cfg, t5, t), clip_tokens, tokens)
    launches = read_launches()
    if any(launches.values()):  # plain PyTorch, as the JAX package's einsums
        raise SmokeFailure(f"phase20 (b): the T5 and CLIP encoders launched port kernels: "
                           f"{launches}")
    cpu_row = E.t5_encode(t5cfg, _tree_map(lambda a: a.cpu(), t5), tokens[:1].cpu())
    abs_err, rel = rel_err(enc[:1].cpu(), cpu_row)
    shapes = [tuple(p.shape) for p in pair]
    if (rel > T5_TOL or shapes != [(4, 77, 768), (4, 77, 1024)]
            or not all(bool(torch.isfinite(p).all()) for p in pair)
            or not torch.equal(pair[1], enc)):
        raise SmokeFailure(f"phase20 (b): T5 row against the CPU rel {rel:.3e} (tol {T5_TOL}); "
                           f"clip_t5_encode shapes {shapes}")
    n_params = sum(a.numel() for a in tree_leaves(t5))
    print(f"phase20: (b) T5 v1.1-large ({t5cfg.num_layers} layers, d_model {t5cfg.d_model}, "
          f"{t5cfg.num_heads} heads, d_ff {t5cfg.d_ff}, {n_params / 1e6:.1f}M params, f32, TF32 "
          f"off, random weights) over [4, 77] tokens on {card}: {1000 * sec:.2f} ms (first call "
          f"{1000 * first_s:.2f} ms); row 0 against the CPU port max |d| {abs_err:.3e} (rel "
          f"{rel:.3e}, tol {T5_TOL}); clip_t5_encode with SD-1.5's CLIP: {shapes}", flush=True)
    del t5, enc, pair

    # (c) the posterior's kl and nll at 512^2
    x = torch.as_tensor(image, device=dev)[None].float() / 127.5 - 1.0
    reset_launches()
    with torch.inference_mode():
        post = M.vae_encode(base.vae_cfg, base.vae_params, x)
        sample = post.sample(torch.Generator(device=dev).manual_seed(27))
        kl, nll = post.kl(), post.nll(sample)
    launches = read_launches()
    check_vae_path(launches, "phase 20's encode", 0, 1, 4096)
    paths["kl_nll_encode_b1"] = launches
    cpu = M.DiagonalGaussian(post.mean.cpu(), post.logvar.cpu())
    kl_rel = abs(float(kl[0]) - float(cpu.kl()[0])) / abs(float(cpu.kl()[0]))
    nll_rel = abs(float(nll[0]) - float(cpu.nll(sample.cpu())[0])) / abs(
        float(cpu.nll(sample.cpu())[0]))
    if tuple(kl.shape) != (1,) or tuple(nll.shape) != (1,) or max(kl_rel, nll_rel) > KL_TOL:
        raise SmokeFailure(f"phase20 (c): kl {tuple(kl.shape)} rel {kl_rel:.3e}, nll "
                           f"{tuple(nll.shape)} rel {nll_rel:.3e} (tol {KL_TOL})")
    print(f"phase20: (c) DiagonalGaussian.kl / .nll of the bf16 encoder's 512x512 posterior "
          f"(64x64x4) on {card}: kl {float(kl[0]):.6g}, nll {float(nll[0]):.6g}; against the "
          f"CPU on the same moments rel {kl_rel:.3e} / {nll_rel:.3e} (tol {KL_TOL})", flush=True)
    del base, post
    torch.cuda.empty_cache()

    # (d) two ranks on cuda:0
    paths.update(phase20_ranks(2, "gloo", card))
    print(f"phase20: {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    return paths


# phase 22: a UNet at the widths of CompVis latent-diffusion's
# configs/latent-diffusion/celebahq-ldm-vq-4.yaml (ffhq-ldm-vq-4.yaml and
# lsun_bedrooms-ldm-vq-4.yaml set the same), model.params.unet_config.params:
# 3 channels in and out on a 64x64 latent, unconditional
LDM_VQ4_UNET = {"image_size": 64, "in_channels": 3, "out_channels": 3, "model_channels": 224,
                "attention_resolutions": [8, 4, 2], "num_res_blocks": 2,
                "channel_mult": [1, 2, 3, 4], "num_head_channels": 32}
LDM_STEPS = 20  # DDIM steps of phase 22 (b), at batch 4
LDM_TOL = {"bfloat16": 5e-2, "float32": 1e-4}  # rel L2 vs the CPU twins (phases 3 and 11's)


def check_ldm(launches: dict, cfg, ub: int, calls: int, what: str) -> dict:
    """``calls`` no-context UNet calls of ``cfg`` (LDM-VQ-4's widths, its
    dtype) at UNet batch ``ub`` on a 64x64 latent: K1 twice a transformer
    whose self-attention has more than SHORT_KV keys (with no context its
    attn2 attends to its own tokens too) on the body of the dtype (sm90,
    fused 3xTF32); K2 its plans' kernels on its body; K3 a call a GroupNorm
    (the fused up path's on its two-source form) with the kernels its plans
    predict; K4 every conv its gate admits, all on the Hopper body of the
    dtype and none on the generic or narrow ones: the counts
    ``unet_call_launches`` predicts, by ``k4_body``. Returns the prediction
    of one call."""
    per = unet_call_launches(cfg, 64, ub, cfg.dtype)
    f32 = cfg.dtype == "float32"
    k1, k2, k4 = 2 * per["k1"] * calls, per["k2"] * calls, per["k4"] * calls
    want = {"attention": k1, "attention_sm90": 0 if f32 else k1,
            "attention_f32_fused_sm90": k1 if f32 else 0, "geglu_ff": k2,
            "geglu_ff_f32_sm90": k2 if f32 else 0, "conv3x3": k4,
            "conv3x3_sm90": 0 if f32 else k4, "conv3x3_f32_sm90": k4 if f32 else 0,
            "conv3x3_narrow": 0, "group_norm calls": per["k3"] * calls,
            "attention_f32_sm90": 0, "attention_bf16_wide_sm90": 0, "attention_cm": 0}
    want.update({p: 0 for p in PROBES})
    got = {k: launches[k] for k in want}
    body = "k4_f32" if f32 else "k4_sm90"
    if got != want or per["k4_generic"] or per[body] != per["k4"] or not per["k4"]:
        raise SmokeFailure(f"{what} launched {got}: want {want} ({per} a call: every gated conv "
                           f"on K4's Hopper body of the dtype, none on its generic body)")
    check_cat(launches, cat_counts(per, calls), what)
    if (launches["group_norm"] != launches["group_norm planned"]
            or launches["group_norm_prior"]):
        raise SmokeFailure(f"K3 in {what}: {launches['group_norm']} kernels against "
                           f"{launches['group_norm planned']} planned, the replaced body "
                           f"{launches['group_norm_prior']}")
    return per


def phase22(dev, card: str) -> dict:
    """A UNet at CompVis LDM-VQ-4's widths (224 / 448 / 672 / 896; the
    params typed above, mapped by ``config.unet_config_from_yaml``), random
    weights from seed 22, no context: (a) one bf16 UNet call at UNet batch
    2 (the up path fused) and one f32 call at UNet batch 1 on a 64x64
    latent against the plain twins on CPU copies (TF32 off); (b) DDIM 20
    steps at batch 4 in bf16 with the UNet as eps, timed cold; (c) each
    path's launches as ``check_ldm`` predicts them: every conv K4's gate
    admits (C and Co 32 mod 64 among them) on a Hopper body, none on the
    generic one; (d) K6 on the 20 ResBlock convs of the 32^2 and 16^2
    planes in both dtypes (phase 9's probe), none on its first body.
    Returns the launches of each path."""
    import torch

    from complex_prompt_diffusion_tpu_torch import config, convert
    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch import schedules as S
    from complex_prompt_diffusion_tpu_torch.pipeline import _tree_map, _unzero_kernels
    from complex_prompt_diffusion_tpu_torch.samplers.ddim import sample_ddim
    from complex_prompt_diffusion_tpu_torch.tools.kernel_cases import ldm_vq4_config
    from complex_prompt_diffusion_tpu_torch.train.optimizers import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    cfg16 = config.unet_config_from_yaml(LDM_VQ4_UNET)
    if cfg16 != ldm_vq4_config() or cfg16.dtype != "bfloat16" or cfg16.context_dim is not None:
        raise SmokeFailure(f"LDM-VQ-4's UNet config {cfg16} is not phase 1's ldm_vq4 group's")
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(22)
    raw = with_biases(_unzero_kernels(gen, M.init_unet(gen, cfg32, dev)), dev, 22)
    params = {"bfloat16": convert.unet_params(raw, dev, torch.bfloat16),
              "float32": convert.unet_params(raw, dev, torch.float32)}
    del raw
    n_params = sum(a.numel() for a in tree_leaves(params["float32"]))
    cpu = torch.device("cpu")
    cgen = torch.Generator().manual_seed(22)
    paths = {}

    # (a) one call of each dtype against the plain twins on CPU copies
    for cfg, ub in ((cfg16, 2), (cfg32, 1)):
        x = torch.randn((ub, 64, 64, 3), generator=cgen)
        t = torch.tensor([801, 301][:ub])
        reset_launches()
        with torch.inference_mode():
            got = M.unet_apply(cfg, params[cfg.dtype], x.to(dev), t.to(dev), None)
            torch.cuda.synchronize()
            launches = read_launches()
            got = got.float().cpu()
            want = M.unet_apply(cfg, _tree_map(lambda a: a.to(cpu), params[cfg.dtype]), x, t,
                                None).float()
        what = f"the {cfg.dtype} LDM-VQ-4 UNet call at UNet batch {ub}"
        per = check_ldm(launches, cfg, ub, 1, what)
        if tuple(got.shape) != (ub, 64, 64, 3) or not bool(torch.isfinite(got).all()):
            raise SmokeFailure(f"{what}: output {tuple(got.shape)}, finite "
                               f"{bool(torch.isfinite(got).all())}")
        rel = float((got - want).norm() / want.norm())
        print(f"phase22: (a) LDM-VQ-4 widths UNet ({n_params / 1e6:.1f} M params, no context) "
              f"{cfg.dtype} at UNet batch {ub} on a 64x64 latent, CUDA kernels vs CPU plain twins "
              f"(TF32 off): rel L2 {rel:.3e} (tol {LDM_TOL[cfg.dtype]:.0e}); K4 {per['k4']} "
              f"convs all on its {'f32' if cfg.dtype == 'float32' else 'bf16'} Hopper body "
              f"(generic 0), K1 {2 * per['k1']}, K2 {per['k2']} kernels, K3 {per['k3']} calls "
              f"({per['k3_cat']} two-source) ({card})", flush=True)
        if not rel <= LDM_TOL[cfg.dtype]:
            raise SmokeFailure(f"{what}: the kernel path disagrees with the plain path: {rel:.3e}")
        paths[f"ldm_vq4_unet_{cfg.dtype}_ub{ub}"] = launches

    # (b) DDIM 20 steps at batch 4, bf16, unconditional, from the first call
    itab = S.make_inference_tables(S.make_diffusion_tables(), LDM_STEPS, eta=0.0)
    x_T = torch.randn((4, 64, 64, 3), generator=torch.Generator(device=dev).manual_seed(23),
                      device=dev)

    def eps(x, t, uc_scale, blur=None):
        t = torch.as_tensor(t, device=dev).reshape(-1).expand(x.shape[0])
        return M.unet_apply(cfg16, params["bfloat16"], x, t, None).float()

    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        x0, traj = sample_ddim(eps, x_T, itab, torch.ones(LDM_STEPS))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    per = check_ldm(launches, cfg16, 4, LDM_STEPS, "phase 22's DDIM sampling")
    check_latents(x0, (4, 64, 64, 3))
    if traj.shape[0] != LDM_STEPS:
        raise SmokeFailure(f"phase 22's DDIM trajectory has {traj.shape[0]} steps")
    print(f"phase22: (b) LDM-VQ-4 widths DDIM {LDM_STEPS} steps b4 bf16 (UNet batch 4, up path "
          f"fused, no context) on {card}: {secs / LDM_STEPS:.4f} s/step cold (the first step's "
          f"warm-up included), {secs:.3f} s, peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; x0 mean "
          f"{float(x0.mean()):.5f} std {float(x0.std()):.5f}; K4 {launches['conv3x3']} convs = "
          f"{per['k4']} x {LDM_STEPS}, all {launches['conv3x3_sm90']} on its sm90 body, 0 on the "
          f"generic one; launches {json.dumps(launches)}", flush=True)
    paths["ldm_vq4_ddim_b4"] = launches

    # (d) K6 on the ResBlock convs of the 32^2 and 16^2 planes
    paths["winograd_probe_ldm_vq4_convs"] = winograd_probe(
        "phase22 (d)", "the LDM-VQ-4 widths UNet's", cfg16, params["bfloat16"], dev, card)
    del params
    torch.cuda.empty_cache()
    print(f"phase22: {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50,
                    help="DDIM steps of the renders (phases 2, 4, 6 and 11)")
    ap.add_argument("--ranks", type=int, default=0,
                    help="run only phase 20 (d), on this many NCCL ranks, a card each")
    args = ap.parse_args(argv)

    if not (ROOT / PKG / "csrc").is_dir():
        raise SmokeFailure(f"{PKG}/csrc not found beside chip_smoke.py")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: no CUDA device")
    dev = torch.device("cuda:0")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from complex_prompt_diffusion_tpu_torch import _build

    t0 = time.perf_counter()
    _build.kernel_library()
    print(f"phase0: kernels built (nvcc, unless this checkout had built them) and "
          f"loaded in {time.perf_counter() - t0:.2f} s ({card})", flush=True)

    if args.ranks:
        if args.ranks > torch.cuda.device_count():
            raise SmokeFailure(f"--ranks {args.ranks}: {torch.cuda.device_count()} cards")
        phase20_ranks(args.ranks, "nccl", card)
        print(card)
        return 0
    phase0_sass(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    summary = phase1(dev, card)
    bundle, main_launches, latents, images = phase2(dev, card, args.steps)
    phase3(bundle, dev, card)
    bundle16 = bundle.cast_vae("bfloat16")
    paths = {"txt2img_b4": main_launches,
             "txt2img_b1_bf16_decode": phase4(bundle16, dev, card, args.steps),
             "bf16_decode_b4": phase5(bundle16, latents, images, card),
             "img2img_b1": phase6(bundle16, images[0], card, args.steps)}
    paths["txt2img_b4_dpmpp2m_cm"], paths["unet_cm_sites_bf16_f32"] = phase7(
        bundle, dev, card, K_STEPS)
    paths["img2img_b1_euler_a_kcanon"] = phase8(bundle16, images[0], card, K_STEPS)
    paths["samplers_b1"] = phase12(bundle16, images[0], card)
    paths.update(phase14(bundle16, images[0], card))
    paths.update(phase21(bundle, dev, card))
    for name in PROBES:
        if any(p[name] for p in paths.values()):
            raise SmokeFailure(f"the probe {name} was launched in a render: no layer "
                               "dispatches it")
    paths["winograd_probe_unet_convs"] = phase9(bundle, dev, card)
    paths["tpu_probe_scripts"] = phase10(dev, card)
    del bundle, bundle16
    torch.cuda.empty_cache()
    paths["txt2img_b1_f32"], paths["txt2img_default_bundle"] = phase11(dev, card, args.steps)
    paths.update(phase13(dev, card))
    paths.update(phase15(dev, card, images[0]))
    paths.update(phase16(dev, card))
    paths.update(phase17(dev, card, images[0]))
    paths.update(phase18(dev, card))
    paths.update(phase19(dev, card))
    paths.update(phase20(dev, card))
    paths.update(phase22(dev, card))

    kernels = []
    # "attention" and "conv3x3" count every body of K1 and K4: their own
    # bodies' launches are those less the sm90 bodies'
    own = {k: {n: p[n] - sum(p[s] for s, total in SM90.items() if total == n) for n in p}
           for k, p in paths.items()}
    for name, (src, rep) in KERNELS.items():
        sm = summary[name]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(p[name] for p in own.values()),
            "launches_by_path": {k: p[name] for k, p in own.items()},
            "max_abs_err": sm["max_abs_err"], "ms": sm["ms"], "plain_ms": sm["plain_ms"],
            "bound_ms": sm["bound_ms"],
            "bound_by": max(sm["by"], key=sm["by"].get),
            "library_ms": sm["library_ms"],
        }
        route = name
        while route in SM90:  # a Hopper body -> the wrapper that counts every body
            route = SM90[route]
        entry["backward"] = BACKWARD.get(name, BACKWARD.get(
            route, "none: a probe, as in the JAX package"))
        if sm["replaced_ms"] is not None:
            entry["replaced_body_ms"] = sm["replaced_ms"]
        if sm["materialized_ms"] is not None:
            # K3's two-source forms: beside them, the materialized port path
            # (torch.cat, then K3 on the concat)
            entry["materialized_ms"] = sm["materialized_ms"]
        if name == "probe_attention":
            entry["sources"] = list(PROBE_ATTENTION_SOURCES)
        elif name == "probe_groupnorm":  # K3's kernels, in K8's modes
            entry["sources"] = [src, f"{PKG}/csrc/groupnorm_sm90.cuh"]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
