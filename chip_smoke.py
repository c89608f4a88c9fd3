#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives incubator_mxnet_tpu_torch only (never JAX or the JAX package):

1. env     — card name, power limit and compute capability (must be 9.0).
2. build   — compiles every CUDA kernel of the port from the checkout's
             sources (one nvcc per source, all started together), with
             ptxas's registers and spill stores per kernel instance.
3. kernel  — each kernel against its plain PyTorch version on the card, at
             the serving, NMT and bf16 training shapes and at edge cases,
             timed with CUDA events beside the plain version and one
             PyTorch library call, and by
             the device time of its kernels (torch.profiler) beside the
             library call's.
4. serve   — BERT-base at full width (random weights from seed 0, f32)
             behind InferenceEngine on cuda:0, which replays a captured
             CUDA graph per bucket: warmup must capture 4 programs and
             traffic none; a burst of 12 singles from 3 threads and one
             batch of 3, every result checked and one request's logits
             held against a CPU copy of the model (which takes the plain
             attention path); then a sustained window of 600 singles
             from 3 closed-loop clients (8 outstanding each), with rate
             and e2e tail over the whole window.  The wrappers count 12
             launches per capture; per bucket, the replayed program
             against the same forward run eagerly (CUDA events, median
             of 20) and a whole replayed batch's wall, busy share and 12
             flash launches by the profiler's kernel names.  A
             refresh_params_from of a second BERT-base while a client
             submits (no capture; its logits served after), and two
             replicas on cuda:0 with retries off and the serve.infer
             fault at calls 2 and 4: replica 1 marked unhealthy, traffic
             routed around it, a probe re-admitting it after the
             cooldown.
   profile — device time by kernel over full-bucket forwards
             (torch.profiler), and the device's busy share of that wall.
5. kernel_bwd — the flash backward's dQ and dK/dV kernels (tensor cores:
             bf16 mma.sync, f32 as 3xTF32) against their plain versions on
             the card, over the forward phase's cases, timed beside the
             plain versions and the backward of scaled_dot_product_attention
             alone (autograd.grad over a kept graph), read as the device
             time of the kernels it launches, with their names; the pair's
             own device time, each kernel's, and the pair's ratio to the
             library's beside it.
6. train   — BERT-base MLM at full width (f32, dropout 0, output_hidden
             + FusedMLMCELoss, Adam lr 1e-4, batch 8 x 512 tokens from
             RandomState(0)): one batch-1 step's loss and every gradient
             against a CPU copy of the model; 2 warm-up and 10 timed
             steps (step ms by CUDA events, tokens/s, peak memory, every
             loss finite); each step launches each of the three kernels
             12 times.
   train_profile — device time by kernel over one training step.
7. train_bf16 — BERT-base as bench.py's run_bert trains it: bert_base and
             FusedMLMCELoss cast to bf16 (Block.cast), Adam lr 1e-4,
             batch 16 x 512 from RandomState(0): a batch-1 step's loss and
             worst gradient against an f32 CPU copy holding the same
             bf16-valued weights, by the kernels and by the plain route
             (every flash kernel's plain version on the card), the
             kernels held to twice the plain route's errors; 2 warm-up and
             10 timed steps (step ms by CUDA events, tokens/s, peak
             memory, every loss finite), each launching each kernel 12
             times, every launch a bf16 instance; the vocab projection's
             two routes (cuBLAS bf16 GEMMs with f32 output, and the
             operands upcast to f32) timed at the step's shape.
   train_bf16_profile — device time by kernel over one such step.
8. kernel_conv — the fused 1x1-conv + BatchNorm-statistics kernel at the
             12 shapes of a ResNet-50 step and the 19 of a MobileNetV2
             step (bf16, batch 128), the tool's 5 shapes in f32 and
             ragged shapes, each with the kernel instance it takes (every
             ResNet-50 shape must take the tensor cores): its sums and f32 y against the plain version, and a
             bf16 y, the kernel's and the plain version's, against the
             exact product; timed beside the plain version, the library
             route (cuDNN's 1x1 convolution, then the two f32 sums) and
             cuDNN's 1x1 convolution alone.
9. train_resnet — resnet50_v1b (1000 classes, random weights from seed 0)
             + SoftmaxCrossEntropyLoss + SGD (lr 0.1, momentum 0.9, wd
             1e-4), as bench.py's run_cachedop: one batch-2 f32 step's
             loss, 161 gradients and running statistics against a CPU
             copy (gradients against the copy's own rounding spread), a
             small ResNet v1b's gradients against its CPU copy; then
             batch 128 x 3 x 224 x 224 cast to bf16, labels
             from RandomState(0), 2 warm-up and 10 timed steps (step ms by
             CUDA events, images/s, peak memory, every loss finite); each
             step launches the conv kernel 33 times.
   train_resnet_profile — device time by kernel over one such step.
   train_resnet_gluon — the same model and batch trained as a Gluon user
             writes the loop: get_model with the widths deferred,
             initialize(MSRAPrelu, ctx=gpu(0)), no weight decay on beta,
             gamma and bias (collect_params(...).setattr), NAG (lr 0.1,
             momentum 0.9, wd 1e-4) under a warmup-cosine scheduler,
             Accuracy and TopKAccuracy(5) updated with the card's sync
             debug mode set to "error", a Speedometer; hybridized, its
             2 warm-up steps (eager, then the capture) each issuing the
             conv kernel's 33 launches and its 10 timed steps replaying
             them, 33 a step by the profiler's kernel names; every
             parameter materialised by the first forward with the names
             and shapes of train_resnet's; the lr of every step the
             warmup-cosine's; one extra step with every gradient and
             momentum zeroed moving each decayed weight by its weight
             decay alone and nothing else; save_parameters/save_states
             after timed step 5 loaded into fresh objects bit for bit
             (and a bf16 cast of it through a file), whose steps 6-10
             stay within the loss spread of two uninterrupted runs.
   train_resnet_gluon_profile — device time and launches by kernel
             over one such step.
   train_resnet_fed — bench.py's run_cachedop fed from a file: 512
             random 256 x 313 images (RandomState(0), JPEG quality 90,
             label i % 1000) written to a temporary RecordIO file; the
             decode service alone (start-up, images/s over an epoch, its
             workers and the host's cores); resnet50_v1b hybridized with
             normalize_transform(127.5, 64, bf16) installed by
             set_input_transform, fed by ImageRecordIter(workers=
             min(4, cores), dtype uint8, ctx=gpu(0)), which must run that
             many workers: the first fed batch read back equal byte for
             byte to the host decode_record of its records with the
             workers' per-record RNG (labels and pad too); 2 warm-up steps
             (eager, then the capture: 33 conv launches each) and 2 epochs
             (8 steps) timed that only replay, the transform never called
             in them; images/s fed and on a batch already on the card,
             the feed's per-batch counters and the decode wait; 33 conv
             launches a replayed fed step by name, the busy share of an
             epoch's 4 fed steps from its start; the parent's ms an image
             of the JPEG decode, the resize and decode_record; 4 batches
             through a DeviceFeed and by a synchronous copy from the same
             state, losses and every parameter and momentum bit for bit;
             H2D GB/s from pinned and pageable memory; a batch-2 f32 fed
             step against a CPU copy by train_resnet's spread rule, and a
             normalize with mean and std swapped, which that rule must
             refuse.
10. train_nmt — transformer_nmt_base (6 + 6 layers, 512 units, 8 heads,
             vocab 32000, dropout 0, output_hidden + FusedMLMCELoss, Adam
             lr 1e-4, f32) as bench.py's run_transformer_nmt (config 4b):
             one batch-1 step's loss and every gradient against a CPU
             copy; then batch 64 x source 64 x target 64 from
             RandomState(0), 2 warm-up and 10 timed steps (step ms by CUDA
             events, target tokens/s, peak memory, every loss finite);
             each step launches each flash kernel 12 times, 6 of them
             causal (the decoder's self-attention).
   train_nmt_profile — device time by kernel over one such step.
11. decode_nmt — the same model with its vocab projection: init_cache for
             8 of those source rows at differing valid lengths with the
             memory padded past the source, then 16 greedy decode_steps
             on cuda:0 (ms per step); each step's logits against the
             teacher-forced forward over the same prefix on the card and
             against a CPU copy's decode steps.  The decode step attends
             with torch.bmm: no flash kernel may launch.
   decode_nmt_profile — device time by kernel over one prefill and its
             greedy steps.
12. generate_nmt — the same model behind GenerationEngine on cuda:0 (32
             slots, max_len 128, prompt buckets 16/32/64/128, lanes hi
             and lo at quotas 1.0 and 0.5, queue 256): warmup must
             capture 6 programs (a prefill per bucket, the join, the
             decode step); 8 requests of prompt lengths 5-128 submitted
             together must each equal the eager greedy loop for that
             request alone, and the first 4 steps of 2 of them a CPU
             copy's, logits within SERVE_TOL (a token may differ only
             where the reference's top-2 logit gap is within the
             tolerance; the comparison then stops and prints the gap);
             the replayed decode step's ms at 32 slots beside the same
             captured function run eagerly (CUDA events, median of 50);
             closed-loop capacity for 3 s; then open-loop Poisson traffic
             at twice it for 5 s (20 % hi, budgets 3-64, deadlines
             calibrated to the capacity) with continuous and with drain
             batching: offered and achieved rps, tokens/s, hi-lane TTFT
             and inter-token p50/p99, shed fraction, 0 captures during
             traffic; after close() every stream resolved, no unfinished
             task, every cache leaf on its warmup storage, no donation
             copy; no port kernel may launch (masked attention and the
             cached step are unfused).
   generate_nmt_profile — device time by kernel and busy share over 20
             replayed decode steps, with the cache write-back copies.
12b. serve_registry — BERT-base (as in serve, lanes hi and lo) and the
             generator (as in generate_nmt) behind one ModelRegistry on
             cuda:0: 4 + 6 captures at warmup; each model's ledger row
             (projected, then measured) beside the tensors its engine
             holds, its programs' pool growth, memwatch's sample and the
             allocator; a third registration denied under a budget of
             what is committed plus half its projection, with
             memory_allocated unchanged; registry BERT bit-equal to a
             standalone engine at buckets 8 and 1, 4 generations
             token-equal to the eager loop; a v2 canary at fraction 0.25
             tainted by the model.bad_version fault (1 s stall a batch)
             rolled back by the default serving rules' action hook; the
             breaker opened by two faulted calls and closed by one probe
             after its cooldown; 5 s of BERT singles (3 closed-loop
             clients x 8, lanes and tenants alternating) beside Poisson
             generation at half its closed-loop capacity: p50/p99 per
             model and lane, TTFT and inter-token p50/p99, tokens/s,
             sheds, 0 captures.
13. hybridize — train_bf16, train_nmt and train_resnet_gluon (the same
             models, batches, data and optimizers) each run twice from
             seed 0: eager, and hybridized as bench.py hybridizes them
             (the net with static_alloc and static_shape, the loss block
             plain), so that forward and backward replay captured CUDA
             graphs and the Trainer replays its captured update.  For
             each mode: 2 warm-up and 10 timed steps (step ms by CUDA
             events, tokens/s or images/s, peak memory), 2 profiled steps
             (busy share, each of the port's kernels' launches per step
             by name), the launch counters of every warm-up and timed
             step, the captures, replays and eager updates during the
             warm-up and the timed steps.  A profiled step of either mode
             must launch each kernel as often as an eager step's counters
             say (12/12/12 flash, 33 conv); the counters of the warm-up
             step that captured must say the same (6 causal in NMT: what
             its graphs hold), and those of the hybridized timed steps,
             which only replay, nothing.  One eager bf16 and NMT
             step's host time by op (torch.profiler, top 15).  The 10
             losses and the final parameters must be equal bit for bit, or
             else within a third (eager) run's own distance from the first;
             the kernel names only one mode ran are printed.  The save and
             resume round of train_resnet_gluon above already runs
             hybridized (its nets and loss block are).
13b. ndarray — the mx.nd surface at full width, f32, seed 0 and inputs
             from RandomState(0): bert_base + FusedMLMCELoss fed
             nd.array(tokens, ctx=mx.gpu(0), dtype="int32") returns an
             NDArray bit for bit the same call fed the tensor (12 forward
             launches), and one Adam step under record() with
             loss.backward() on the NDArray loss, from a copy of the same
             start as a step fed tensors: loss, every gradient and
             updated parameter bit for bit (12 launches of each kernel);
             an attention block written only in nd ops (three
             nd.FullyConnected(flatten=False), nd.contrib.flash_attention
             over 12 heads, the output projection, nd.LayerNorm of the
             residual, nd.mean(nd.square(h - t))) at batch 8 x 512 x 768,
             its eight weights and biases attach_grad()-ed, two steps of
             record, backward and nd.adam_update(out=(w, m, v)), held
             against the same script with attention's plain version on
             the card (loss by TOL, gradients by BWD_TOL of their scale
             floored at 1e-3 of the step's largest, as train's rule for
             the key bias, updated weights by BWD_TOL of theirs), one
             launch of each kernel a step;
             a gradient penalty through nd.FullyConnected(768 -> 3072),
             nd.Activation(tanh) and nd.FullyConnected(3072 -> 768) by
             autograd.grad(create_graph=True) and a second backward, its
             weight gradients against torch.autograd.grad over the same
             tensors, and its ms; the host us per call (median of 1000)
             of nd.broadcast_add and NDArray + on (768,) beside
             torch.add.  The flash rows of the kernels line carry these
             launches as nd_launches.
13c. kernel_nms — the greedy NMS kernel (a count launch where flags
             are given, a mask launch and a scan launch) against its plain
             version on the card, keep flags and kept positions exactly:
             Proposal's shape (2 x 2000, IoU > 0.7 by the +1 convention,
             the first 1000 kept), box_nms's (8 x 4096, class-aware over
             20 classes, valid_thresh 0), MultiBoxDetection's (8 x 24,564,
             class-aware over 20, IoU 0.5, flags on a sorted prefix of
             about 1.3 % of each image; the plain version on the prefix
             that holds every valid box, the kernel's flags past it all
             False), flags that are no prefix (2 x 2000, corner IoU),
             Proposal's shape in the positions-only mode (the scan ends
             at the 1000th kept box) against the plain mode, and repeated
             boxes with tied scores both ways; box_nms end to end by the
             kernel and by the plain route on tied scores.  Five shapes
             timed (CUDA events, median of 5 x 20) beside the plain
             version, each launch's device time, the scratch bytes and the
             bound (the needed pairs' IoUs on the CUDA cores).  There is no
             PyTorch NMS call on the card's machine (no torchvision).
13d. train_ssd — bench.py's config 3a: ssd_512_vgg16(classes=20),
             initialize(ctx=cuda:0), a batch-1 f32 step's loss and 79
             gradients against a CPU copy at 512 x 512 (loss, median
             gradient error), and the same step in float64 activations,
             every gradient within 1e-6 of its scale; then
             net and SSDTrainLoss hybridized, batch 8 of 512 x 512 bf16
             images from RandomState(0), one gt box [1, .2, .2, .7, .7]
             each, SGD lr 0.01 momentum 0.9: 2 warm-up steps (eager, then
             captured) and 10 timed ones that only replay (step ms,
             images/s, peak memory, captures and replays), 2 profiled
             steps (busy share); then MultiBoxDetection of the trained
             batch's softmaxed scores over its 24,564 anchors through the
             NMS kernel (one launch; its count, mask and scan kernels by
             profiler name), held to the greedy invariants per image and
             class (no kept pair above 0.5, every suppressed box
             overlapped above 0.5 by a kept box scoring at least as
             high), its ms, and its NMS's valid boxes per image, scratch
             bytes and bound (the same-class pairs of its valid boxes).
13e. train_rcnn — bench.py's config 3b: faster_rcnn_resnet50_v1b(
             classes=20), staged parity at batch 1 f32 (the RPN's outputs
             against a CPU copy; Proposal and ProposalTarget on the card's
             RPN outputs by the kernel and by the plain route, exactly; the
             head's loss and every gradient it reaches against the CPU
             copy fed the card's 32 sampled rois); then net and
             RCNNTrainLoss hybridized, batch 2 of 600 x 800 bf16 images,
             im_info [600, 800, 1], gt [60, 60, 260, 260, 1] and [200,
             200, 420, 420, 2], 256 sampled rois, SGD lr 1e-3 momentum
             0.9, timed as train_ssd but after 3 warm-up steps (the eager
             one leaves the RPN without gradients, the captured backward
             gives it zeros, so the Trainer captures at the third); the
             eager and the capturing step launch the conv kernel 33 times
             and the NMS kernel once, a replayed step the same by profiler
             name.  The head's gradients are held, as train_resnet's,
             by their largest and median error to 3 x the CPU copy's own
             spread under a 2**-22 change of its input (batch-1
             BatchNorm's cancelling sums).
13f. train_lamb — BERT-base MLM as train_bf16 builds it (bf16, batch 16
             x 512, the same data) trained with LAMB (lr 1e-4, wd 0.01,
             epsilon 1e-6; no weight decay on LayerNorm gamma/beta and
             biases, as GluonNLP's run_pretraining.py), eager and
             hybridized through the hybridize phase's run: 12 launches of
             each flash kernel a replayed step by name, the timed steps
             only replaying, losses and parameters of both modes bit for
             bit, the hybridized Trainer's one eager update and one
             capture; the captured update's device ms and launches beside
             train_bf16's Adam update captured and timed alike; one LAMB
             update of every bf16 weight from fixed gradients against the
             port's update of bf16 CPU copies of their values: each
             element within one bf16 ulp of itself plus 2**-5 of its
             step, at most 1 % of the moved elements with another step,
             and planted controls (no update, lr x 2, the step negated)
             failing that check.  The
             weights are pure bf16 with no f32 master copy (the brief's
             Trainer settings; multi_precision copies only float16), so
             a step of about lr x rms(w) moves only the elements near 0:
             the share moved is printed (moved_share).
13g. optimizers — a user block written with hybrid_forward under
             name_scope (a Dense child, a params.get weight filled by its
             own infer_shape; batch 64, 256 -> 512 -> 10) trained 6 steps
             under a FactorScheduler by each of AdaGrad, AdaDelta,
             RMSProp (plain and centered), Ftrl, Signum, SignSGD, LAMB,
             Adamax, Nadam, SGLD and Test, and by Adam and LAMB with
             multi_precision on float16 weights: eager and hybridized on
             the card bit for bit, the Trainer's 1 eager update, 1 capture
             and 4 replays, the block's 2 captures; the losses within
             1e-4 of the same run on a CPU copy; 6 updates from the same
             gradients within 1e-5 of scale of the CPU's (float16 weights
             within one float16 ulp); SGLD's replayed noise (2**20 zero
             weights) differing between replays, its mean and variance
             within 4 sigma of 0 and lr; each of the ten new losses as a
             hybridized block (eager, capture, replay) against the CPU,
             value and input gradients within 1e-5 of scale.
13h. train_mobilenet — mobilenet_v2_1_0 (1000 classes) through the
             Gluon loop of train_resnet_gluon: get_model with the widths
             deferred, initialize(MSRAPrelu, ctx=gpu(0)), batch 128 x 3 x
             224 x 224 bf16 from RandomState(0), NAG (lr 0.1, momentum
             0.9, wd 4e-5, GluonCV's mobilenetv2_1.0) under the
             warmup-cosine schedule, no wd on beta, gamma and bias; eager
             and hybridized through the hybridize phase's run (bit for
             bit, 34 conv launches a step by the counters and by the
             profiler's kernel names, the timed steps only replaying);
             before it, one f32 batch-2 step against a CPU copy
             (gradients by the train_resnet spread rule), whose forward's
             pointwise sites must be conv_stats.MOBILENET_V2_CONV_SHAPES;
             from the hybridized step's profile, the depthwise
             convolutions' device ms (torch's conv_depthwise2d kernels)
             and share of the step, and the conv kernel's device ms;
             step ms, images/s, busy share and peak memory with the
             card's name and power limit.
13i. zoo — resnet50_v2, vgg16_bn, alexnet, densenet121, squeezenet1_1,
             mobilenet1_0, mobilenet_v3_large (224) and inception_v3
             (299) at their published widths, hybridized: an eager, a
             capturing and a replayed bf16 SGD step at batch 8 (losses
             finite), a profiled replay whose conv launches by name equal
             the net's fused pairs (gluon.nn.fused_pairs), the conv
             kernel against its plain version at each distinct pair of
             the eager step on the inputs it had there (y within
             conv_stats.conv1x1_y_bound, the sums within 1e-5), and the
             f32 logits of a batch-2 forward against a CPU copy.
13j. layers — each new gluon.nn and gluon.contrib.nn layer and each new
             ops/nn.py op, forward and backward on the card against a
             CPU copy (f32, within 1e-4 of scale).
13k. train_gnmt — gnmt_large (4 x 1024 encoder with a bidirectional
             bottom layer, 4 x 1024 decoder, 1024 embeddings, vocab 32000)
             as bench.py's run_gnmt trains it: output_hidden +
             FusedMLMCELoss(32000, 1024), both cast to bf16, hybridized
             (static_alloc, static_shape), Adam lr 1e-3, batch 128 x 50 /
             50 from RandomState(0); eager and hybridized through the
             hybridize phase's run (bit for bit, the timed steps only
             replaying, 0 captures in them): step ms, target tokens/s,
             busy share, peak memory, the kernels a replayed step
             launches by the profiler's names and the costliest; none of
             the port's five kernels launches on this path.  Before it,
             one f32 batch-2 step against a CPU copy (gradients by the
             train_resnet spread rule, the spread from every weight of the
             CPU copy nudged by 1 +- 2**-22).
13l. generate_seq2seq — bench.py's generation workload (its Seq2Seq:
             vocab 31, embed 24, hidden 32, 2 layers) behind
             GenerationEngine (4 slots, max_len 24, buckets 4 and 8):
             warmup's 4 captures and none in traffic, the tokens of six
             prompts (on and off a bucket) against the eager greedy loop
             (near-tie rule), the replayed decode step against eager.
13m. rnn — every mode of the fused RNN op x {uni, bi} x {dense, varlen}
             through nd.RNN / nd.RNN_varlen on the card against a CPU
             copy, forward and every gradient, f32 (within 1e-4 of scale)
             and bf16 (the train_bf16 rule); then the yardstick, not a
             path: one GNMT encoder layer (T 50, B 128, 1024 -> 1024) of
             the port's LSTM against torch.nn.LSTM (cuDNN) on the same
             weights, f32 within 1e-4 of scale, bf16 forward + backward ms
             of each (the port's layer eager and hybridized), with their
             kernels a call and the bound.
13n. train_wide_deep — bench.py's config 5 (Wide&Deep: 100,000 features
             in 16 fields, embed 16, MLP 64-32, 2 classes, Adam lr 1e-3,
             data from RandomState(0)): (a) run_wide_deep's dense
             headline at batch 32,768, net and loss hybridized, eager and
             hybridized through the hybridize phase's run (bit for bit,
             the timed steps only replaying, no port kernel), step ms,
             samples/s, busy share, launches a replayed step by name,
             peak memory and the step's bound, after one f32 batch-512
             step against a CPU copy (the spread rule, every weight of
             the copy nudged by 1 +- 2**-22); (b) the row_sparse path,
             contrib.sparse_jit.BucketedSparseTrainer at batch 2,048: one
             eager step, one capture of its one key, then replays only;
             step ms, samples/s, unique rows a step, 0 overflow steps;
             (c) the Gluon user's eager sparse path
             (Embedding(sparse_grad=True), the net hybridized but its
             recorded calls eager, Trainer Adam's lazy update) against
             (b) over four batches of 50 to 20,000 pooled rows: losses,
             parameters, rows no batch touched bit for bit; a dense Adam
             and an off-by-one sentinel, planted here only, must each
             fail that check; (d) bucket_rows 4,096 under a batch of
             ~28,000 unique rows: the step skipped on the card, the
             state bit for bit, the previous loss returned.
13o. train_sharded — bench.py's `sharded` config (build_sharded_trainer,
             run_sharded) through parallel.ShardedTrainer on the one-card
             mesh: resnet50_v1b, 1000 classes, 224^2, bf16 parameters
             but BatchNorm's gamma, beta and running statistics, SGD
             momentum 0.9, lr 0.1, wd 1e-4, the first batch of 256, 128,
             64 that fits; 2 warm-up steps (eager, then the whole step
             captured) and 16 timed steps that only replay: images/s
             after a sync, step ms by CUDA events, busy share of a
             profiled step, peak memory, 33 conv-kernel launches a
             replayed step by name.  zero 0, 1, 2 and 3 from the same
             start: 3 losses bit for bit (cuDNN deterministic).  Before
             it, an f32 batch-4 parity of two zero-2 steps on a
             2-replica mesh (both on cuda:0) against CPU replicas: loss,
             running statistics and each step's parameter changes by
             train_resnet's spread rule; the update's rescale left at
             the per-replica batch and momentum dropped at step 2 must
             each fail it.
13p. kvstore — resnet18_v1 as a Gluon user trains it on [gpu(0)]
             (split_and_load, a recorded forward per context, batch 32):
             3 steps with kvstore "device", and "dist_sync" on a
             world-size-1 torch.distributed group (NCCL for card
             tensors), and update_on_kvstore (the store's per-parameter
             update), bit for bit the parameters of kvstore=None (cuDNN
             deterministic); row_sparse_pull of card tensors and 2-bit
             compression of card gradients equal to the CPU's.
13q. multi_card — where the host has 2 or more cards (up to 4 used):
             ShardedTrainer at zero 0 (BatchNorm statistics summed
             across the cards in lockstep, gradients by NCCL) and zero 2
             (reduce-scatter) over the cards in one process, and as one
             rank a card in a torch.distributed NCCL group started by
             the port's launcher (`chip_smoke.py dist-worker`), each
             against the same replicas on one card (8 rows each, f32,
             two steps from the reference's state, the spread rule);
             resnet18_v1's Gluon loop over the cards against the same
             loop over CPU replica contexts.  With one card it prints
             {"multi_card": "not run", "cards": 1}.
14. kernels — one JSON line per the port's kernel table (5 rows), then the
             card's name and power limit, then the final {"ok": true, ...}
             line.

Every phase prints one JSON line; the first failure raises and exits
nonzero with its traceback.  Without a CUDA device it exits 1 and prints
nothing on standard output.
"""
import collections
import contextlib
import functools
import gc
import json
import logging
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# H100 SXM data-sheet peaks (dense) and HBM3 bandwidth, used only for the
# least time a call could take.  An f32-accurate product has two routes on
# the card: scalar FMAs on the CUDA cores (67 TFLOP/s) and the 3xTF32 split
# on the tensor cores (three TF32 products at 495 TFLOP/s for each f32 one,
# so 165 TFLOP/s).  The f32 bound takes the faster route; the f32 phase rows
# carry the CUDA-core bound beside it as bound_cuda_core_ms (the kernels line
# carries bound_ms only).  bf16 runs on the tensor
# cores at 989 TFLOP/s.
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12, "float16": 989e12}
PEAK_FLOPS_F32_CUDA_CORES = 67e12
PEAK_BYTES_S = 3.35e12
SERVE_BUCKETS = (1, 2, 4, 8)
SEQ = 512
# flash forward against its plain version: f32 out and lse (from f32
# scores in every dtype) differ by the same sums in another order
TOL = 1e-4
# unit roundoff of the 16-bit dtypes (half their spacing at 1): a 16-bit
# kernel output is held to 4 u (|ref| + rms(ref)) of its plain version
# (`_low_tolerance`)
ROUNDOFF = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}
# CPU vs card on the served logits, both f32: cuBLAS and the CPU BLAS sum
# in other orders and the kernel's tiled online softmax differs from the
# plain softmax in rounding; through 12 layers of LayerNorm-ed residuals
# this stays near 1e-5 on logits of size ~1, so 2e-3 leaves a wide margin
# while any wrong tile, mask or scale shows up as O(1e-1) or more.
SERVE_TOL = 2e-3
# flash backward against its plain version in f32: the same sums in
# another order, far below 1e-4 of the largest gradient; a wrong tile,
# mask, scale or delta moves gradients by O(1) of that size
BWD_TOL = 1e-4
# one batch-1 training step, card against a CPU copy, both f32: cuBLAS,
# the CPU BLAS and the flash kernels sum in other orders through 12
# layers forward and back.  Each gradient's max-abs error is held to
# 1e-3 of its max-abs value.  That value is floored at 1e-3 of the
# model's largest gradient: attn.key.bias has a gradient of exactly 0 in
# exact arithmetic (softmax ignores a shift of a row's scores), so its
# rounding noise is held to the model's scale.  A dropped or wrong
# attention gradient moves the q/k/v projections' gradients by O(1).
TRAIN_TOL = 1e-3
TRAIN_BATCH = 8
TRAIN_WARMUP = 2
TRAIN_STEPS = 10
PROFILE_STEPS = 2   # profiled steps of each eager and hybridized run
# bench.py's run_bert: BERT-base cast to bf16 at batch 16 x 512.  A bf16
# step cannot be held to the f32 TRAIN_TOL.  Its batch-1 step is read
# against an f32 CPU copy holding the same bf16-valued weights, by the
# kernels and by the plain route (the card's step with every flash kernel
# replaced by its plain version), and each tensor X (the final hidden
# states and every gradient) is held on its own:
#     e_kernels(X) <= 2 e_plain(X) + ulp(X),
# e the max-abs error against the CPU copy over X's scale (its max-abs
# value, floored at 1e-3 of the largest gradient), ulp(X) one bf16 ulp of
# that scale over the scale.  The two routes round at the same points
# (the plain versions round P, dS and the outputs to bf16 where the
# kernels do) and differ only in the order of f32 sums, which tips a
# rounding here and there by one ulp; those flips travel through the same
# computation as the bf16 roundings that make e_plain, so the routes'
# distance is at most about e_plain, and e_kernels <= e_plain + that
# distance <= 2 e_plain; where e_plain is below X's own rounding, one ulp
# of X's scale is the floor.  A fault in a tile, mask, scale or delta
# moves the hidden states or the well-conditioned gradients (the value
# and output projections, the FFNs, every layer below the fault) by O(1)
# of their scale.  The batch-1 loss (f32 from bf16 hidden states) is held
# to twice the plain route's error plus 1e-6; at random init it hardly
# depends on the network, so the hidden states carry the forward's check.
BF16_BATCH = 16
BF16_ROUTE_FACTOR = 2.0
BF16_LOSS_FLOOR = 1e-6
# fused 1x1 conv + statistics.  f32 y against the plain version: the
# same f32 sums over C in another order, 1e-4 of the largest |y|.  A
# 16-bit y, the kernel's and the plain version's alike, against the exact
# (f64) product e: within conv_stats.conv1x1_y_bound, u |e| (+ 2**-25 in
# f16) + 1.01 C 2**-23 sum_c |w x|, u = 2**-8 in bf16 and 2**-11 in f16,
# what an f32 sum over C in any order and any rounding of its adds, then
# rounded to y's dtype, can miss e by (its docstring derives it).  The sums of N·HW f32 terms in another order: Σy within
# CONV_SUM_TOL of sqrt(N·HW·Σy²) (which is at least Σ|y|), Σy² within
# CONV_SUM_TOL of itself.  A wrong tile or mask moves a sum by O(1) of
# it, a dropped input channel Σy² by about 1/C of it (4.9e-4 at C 2048).
CONV_SUM_TOL = 1e-5
RESNET_BATCH = 128
RESNET_PARITY_BATCH = 2
RESNET_SITES = 33       # pointwise conv + BatchNorm pairs of resnet50_v1b
# running statistics after the parity step, card against the CPU copy:
# batch statistics from the kernel's sums against the CPU's, f32 through
# 50 layers; each tensor within 1e-4 of its scale
RUNNING_TOL = 1e-4
# resnet50_v1b's batch-2 gradients are not a smooth function of the
# inputs at rounding level: scaling the input by 1 + 2**-22 on the CPU
# flips about 80 ReLU decisions and moves most gradients by 1-20 % of
# their scale (the same size at 2**-16: discrete flips, not growth).  So
# the card's gradients are held to RESNET_SPREAD_FACTOR times the spread
# the CPU copy shows against itself under that perturbation, in its
# largest and its median tensor (the spread itself varies with the
# perturbation: 0.17-0.35 of scale in the largest tensor, 0.018-0.027 in
# the median one); a wrong gradient path moves its tensors by O(1) of
# their scale.  The small ResNet below, free of such flips, is held to
# TRAIN_TOL per tensor.
RESNET_SPREAD_FACTOR = 3.0
# the Gluon loop (train_resnet_gluon): GluonCV's ImageNet recipe
# (scripts/classification/imagenet/train_imagenet.py): MSRAPrelu, no
# weight decay on beta, gamma and bias, NAG with a linear warmup into a
# cosine.  max_update spans twice the phase's updates, so the lr stays
# above 0 through the weight-decay step that follows them.
GLUON_NAG = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
GLUON_LR = dict(base_lr=0.1, final_lr=0.0, warmup_steps=2,
                warmup_begin_lr=0.01)
GLUON_MAX_UPDATE = 2 * (TRAIN_WARMUP + TRAIN_STEPS)
GLUON_NO_WD = ".*beta|.*gamma|.*bias"
GLUON_SAVE_AT = 5           # the timed step after which the run is saved
BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
_BatchEnd = collections.namedtuple("BatchEndParam",
                                   ["epoch", "nbatch", "eval_metric",
                                    "locals"])
SMALL_RESNET = dict(layers=[1, 1, 1, 1], channels=[8, 16, 32, 64, 128],
                    classes=10, thumbnail=True, stride_on_3x3=True)
# sustained serving window: closed-loop clients, each keeping INFLIGHT
# singles outstanding, so the queue stays deeper than the largest bucket
WINDOW_CLIENTS = 3
WINDOW_PER_CLIENT = 200
WINDOW_INFLIGHT = 8
SERVE_TIMED = 20            # single calls timed per bucket, both ways
SERVE_PROFILED = 5          # replayed batches profiled per bucket
SERVE_COOLDOWN_S = 3.0      # the replica drill's cooldown
# a stall queued on the default stream just before the swap source is
# written there (about 0.1 s of the card's clock): a swap that does not
# wait for the caller's stream reads the source unwritten
SWAP_STALL_CYCLES = 200_000_000
SERVE_DEVICE = "cuda:0"
REG_LANES = ("hi", "lo")
REG_QUOTAS = (1.0, 0.5)
REG_HI_DEADLINE = 0.5       # s: a healthy batch takes ~0.03
REG_DEGRADE_S = 1.0         # the tainted canary's stall a batch
REG_CANARY_REQUESTS = 48
REG_BREAKER_COOLDOWN_S = 2.0
REG_MIXED_S = 5.0
# bench.py's config 4b: transformer_nmt_base at batch 64, source and
# target 64, vocab 32000
NMT_VOCAB = 32000
NMT_UNITS = 512
NMT_BATCH = 64
NMT_SEQ = 64
NMT_LAYERS = 6
# cached decode: 8 source rows of differing valid lengths, the memory
# padded from 64 to 80 rows, 16 greedy steps from token 1
NMT_DECODE_VALID = (64, 61, 55, 48, 40, 31, 17, 6)
NMT_MEM_LEN = 80
NMT_DECODE_STEPS = 16
NMT_BOS = 1
# generate_nmt: GenerationEngine over transformer_nmt_base
GEN_EOS = 2
GEN_SLOTS = 32
GEN_MAX_LEN = 128
GEN_BUCKETS = (16, 32, 64, 128)
GEN_LANES = ("hi", "lo")
GEN_QUOTAS = (1.0, 0.5)
GEN_QUEUE_CAP = 256
# 8 parity requests: prompt lengths on and off the buckets, budgets <= 64
GEN_PARITY_LENGTHS = (5, 16, 23, 32, 50, 64, 100, 128)
GEN_PARITY_NEW = (64, 40, 64, 17, 64, 33, 64, 50)
GEN_CPU_REQUESTS = 2        # of them, the first steps held to a CPU copy
GEN_CPU_STEPS = 4
GEN_TIMED_STEPS = 50
GEN_PROFILED_STEPS = 20
GEN_MAX_NEW = 64            # the traffic's budgets, uniform in [3, 64]
GEN_CAPACITY_S = 3.0
GEN_OPEN_S = 5.0
GEN_HI_FRAC = 0.2
GEN_RESULT_TIMEOUT = 300


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _time_ms(torch, fn, reps=20, rounds=5):
    """Median over `rounds` of the mean time of `reps` back-to-back calls,
    by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _low_tolerance(ref, dt):
    """4 u (|ref| + rms(ref)) for the 16-bit dtype `dt` of unit roundoff u
    (`ROUNDOFF`): 2**-6 in bf16, 2**-9 in f16.  4 u |ref| is at least 2
    ulps of each element (an ulp is at most 2 u of it), and 4 u rms(ref)
    covers the elements near zero."""
    return 4.0 * ROUNDOFF[dt] * (ref.abs() + ref.pow(2).mean().sqrt())


def _out_tolerance(torch, ref, dt):
    """Elementwise bound on |out - ref| of the flash forward.  16-bit: both
    outputs are rounded to the dtype, and the kernel rounds P against the
    running max where the plain version uses the final max; within
    `_low_tolerance`.  A fault that scales out by 4 u or more (3 % in
    bf16), or mixes up rows of V, exceeds it."""
    if dt == "float32":
        return torch.full_like(ref, TOL)
    return _low_tolerance(ref, dt)


def _roofline(flops, nbytes, dtype, prefix=""):
    """{bound_ms, bound_by}: the least time (ms) of a call that does `flops`
    at the dtype's faster route and moves `nbytes` at HBM bandwidth, and
    which of the two bounds it; for f32 also bound_cuda_core_ms and
    bound_cuda_core_by, the same with the products on the CUDA cores.
    Keys take `prefix`."""
    def one(peak):
        t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_S
        return max(t_ops, t_bytes) * 1e3, \
            "operations" if t_ops >= t_bytes else "bytes"
    out = dict(zip((prefix + "bound_ms", prefix + "bound_by"),
                   one(PEAK_FLOPS[dtype])))
    if dtype == "float32":
        out.update(zip((prefix + "bound_cuda_core_ms",
                        prefix + "bound_cuda_core_by"),
                       one(PEAK_FLOPS_F32_CUDA_CORES)))
    return out


def _bound(BH, T, d, dtype, causal, products, tensors, rows, prefix=""):
    """Roofline of a flash kernel: `products` (T, T, d) matrix products of
    2·d flops per (query, key) pair this mask keeps; `tensors` (BH, T, d)
    operands and `rows` (BH, T) f32 statistics each read or written
    once."""
    elem = 4 if dtype == "float32" else 2
    pairs = T * (T + 1) // 2 if causal else T * T
    flops = 2.0 * products * BH * d * pairs
    nbytes = tensors * BH * T * d * elem + rows * 4.0 * BH * T
    return _roofline(flops, nbytes, dtype, prefix)


def _flash_bound(BH, T, d, dtype, causal):
    """Forward: S and P·V; q, k, v read, out and lse written."""
    return _bound(BH, T, d, dtype, causal, products=2, tensors=4, rows=1)


def _dq_bound(BH, T, d, dtype, causal):
    """dQ: S, dP and dS·K; q, k, v, dO, O and lse read, dq and delta
    written."""
    return _bound(BH, T, d, dtype, causal, products=3, tensors=6, rows=2,
                  prefix="dq_")


def _dkv_bound(BH, T, d, dtype, causal):
    """dK/dV: S, dP, P^T·dO and dS^T·Q; q, k, v, dO, lse and delta read,
    dk and dv written."""
    return _bound(BH, T, d, dtype, causal, products=4, tensors=6, rows=2,
                  prefix="dkv_")


# kernel cases (BH, T, d, dtype, causal): the BERT serving and training
# shape first, then causal, bf16, ragged T and the other head dims, then
# the NMT step's shape (64 x 8 heads, T 64: one tile, every tile on the
# diagonal when causal) both ways, a ragged causal T of one partial tile,
# the bf16 BERT step's shape, and the f16 instances (amp.init("float16"),
# a float16 cast) at the BERT shape and a ragged causal T
BERT_CASE = (96, SEQ, 64, "float32", False)
NMT_CASES = ((NMT_BATCH * 8, NMT_SEQ, 64, "float32", False),
             (NMT_BATCH * 8, NMT_SEQ, 64, "float32", True))
# the bf16 BERT step's shape (batch 16 x 12 heads)
BF16_CASES = ((BF16_BATCH * 12, SEQ, 64, "bfloat16", False),)
CASES = [BERT_CASE, (96, SEQ, 64, "float32", True),
         (96, SEQ, 64, "bfloat16", False), (96, SEQ, 64, "bfloat16", True),
         (8, 200, 64, "float32", False), (8, 200, 64, "bfloat16", True),
         (96, SEQ, 32, "float32", False), (96, SEQ, 128, "float32", False),
         (8, 200, 16, "float32", True)] + list(NMT_CASES) + [
         (NMT_BATCH * 8, 50, 64, "float32", True)] + list(BF16_CASES) + [
         (96, SEQ, 64, "float16", False), (8, 200, 64, "float16", True)]


def phase_kernel(torch, att):
    """Flash forward kernel against its plain version; returns its rows
    by case."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = {}
    for BH, T, d, dt, causal in CASES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(BH, T, d, device="cuda", generator=gen)
                   .mul_(0.5).to(dtype) for _ in range(3))
        scale = 1.0 / math.sqrt(d)
        out, lse = att.flash_attention_fwd(q, k, v, scale, causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = att.flash_attention_fwd_plain(q, k, v, scale,
                                                         causal)
        ref = ref_out.float()
        diff = (out.float() - ref).abs()
        err_out = diff.max().item()
        # the largest error as a share of its element's bound (ok <= 1)
        err_ratio = (diff / _out_tolerance(torch, ref, dt)).max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        ok = err_ratio <= 1.0 and err_lse <= TOL
        ms = _time_ms(torch, lambda: att.flash_attention_fwd(
            q, k, v, scale, causal))
        plain_ms = _time_ms(torch, lambda: att.flash_attention_fwd_plain(
            q, k, v, scale, causal))
        # 4-D (1, BH, T, d) views: PyTorch's fused SDPA backends take 4-D
        q4, k4, v4 = q[None], k[None], v[None]
        library_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, scale=scale))
        # device time of the kernel and of the library's kernels: at a short
        # T a call's host work outlasts its kernel, and back-to-back calls
        # timed by events then read the host's rate
        device_ms, _ = _device_ms(torch, lambda: att.flash_attention_fwd(
            q, k, v, scale, causal))
        library_device_ms, _ = _device_ms(
            torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal, scale=scale))
        row = dict(phase="kernel", name="flash_attention_fwd", BH=BH, T=T,
                   d=d, dtype=dt, causal=causal, err_out=err_out,
                   err_out_over_bound=err_ratio, err_lse=err_lse,
                   tol_lse=TOL, ok=ok, ms=ms, device_ms=device_ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   library_device_ms=library_device_ms,
                   **_flash_bound(BH, T, d, dt, causal))
        _emit(row)
        _check(ok, "flash_attention_fwd disagrees with its plain version: "
                   "%r" % (row,))
        rows[BH, T, d, dt, causal] = row
    return rows


# spin kernels (`torch.cuda._sleep`) that open every profiled window: the
# profiler drops the first device records of a window (seen on the card:
# the first kernels of a training step, the first of 20 launches of a
# kernel), a count of them that grows over a long process (1 early, 7-9
# late in this script's run, whatever the spins' length), so those
# records are the primer's: PRIMER spins of PRIMER_CYCLES, about 50 us
PRIMER = 32
PRIMER_CYCLES = 100_000


def _device_kernels(torch, fn, reps, tries=3):
    """[(device us, kernel name, calls)] of the CUDA kernels that `reps`
    back-to-back calls of `fn` (after one unprofiled call) launch, largest
    first, from torch.profiler, and the host wall of those calls (us).
    The window opens with PRIMER spin kernels, which are not counted; a
    window that lost some of them is printed (`profiler_primer`).
    Only kernels, copies and fills count: a device-side row that bears
    the name of a host row (a `record_function` span, `ProfilerStep*`)
    is an annotation, whose time spans kernels already counted.  Every
    call launches the same kernels, so a trace in which a kernel's count
    is not a multiple of `reps`, or that holds no kernel, lost records:
    the window is profiled again, and after `tries` such traces the run
    fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PRIMER):
                torch.cuda._sleep(PRIMER_CYCLES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        _primer_kept(torch, prof)
        # kernels only: the aten op that launched a kernel carries the
        # same device time again, and an annotation spans them
        events = prof.key_averages()
        host = {ev.key for ev in events if ev.device_type != DeviceType.CUDA}
        rows = [(ev.self_device_time_total, ev.key, ev.count)
                for ev in events
                if ev.device_type == DeviceType.CUDA
                and ev.self_device_time_total > 0 and ev.key not in host
                and not ev.key.startswith("ProfilerStep")
                and "::spin_kernel(" not in ev.key]
        if rows and all(n % reps == 0 for _, _, n in rows):
            rows.sort(reverse=True)
            return rows, wall_us
        _emit(dict(phase="profiler_window_rejected", reps=reps,
                   records=_record_origins(
                       torch, prof, {k for _, k, n in rows if n % reps})))
    raise RuntimeError("torch.profiler lost kernel records of %d calls in "
                       "%d windows: %r" % (reps, tries, rows))


def _primer_kept(torch, prof):
    """Prints how many of the window's primer spins the profiler kept,
    when it lost any."""
    from torch.autograd import DeviceType
    kept = sum("::spin_kernel(" in ev.key for ev in prof.events()
               if ev.device_type == DeviceType.CUDA)
    if kept != PRIMER:
        _emit(dict(phase="profiler_primer", kept=kept, of=PRIMER))


def _record_origins(torch, prof, names):
    """Where the device records named `names` of a profiled window came
    from: counts by (stream, the runtime call that issued them, the host
    thread that made it), and the spread of their start times from the
    window's first device record (us); what each host thread (the
    profiler's thread numbers) called; the threads alive by name."""
    from torch.autograd import DeviceType
    evs = prof.events()
    calls = {ev.id: ev for ev in evs if ev.device_type != DeviceType.CUDA}
    dev = [ev for ev in evs if ev.device_type == DeviceType.CUDA]
    t0 = min((ev.time_range.start for ev in dev), default=0)
    groups = {}
    for ev in dev:
        if ev.name not in names:
            continue
        call = calls.get(getattr(ev, "linked_correlation_id", None)) \
            or calls.get(ev.id)
        key = (ev.name[:60], getattr(ev, "device_resource_id", None),
               call.name if call else None, call.thread if call else None)
        groups.setdefault(key, []).append(ev.time_range.start - t0)
    host = {}
    for ev in calls.values():
        host.setdefault(ev.thread, collections.Counter())[ev.name] += 1
    return dict(
        threads=[t.name for t in threading.enumerate()],
        host_threads={th: dict(calls=sum(c.values()),
                               top=[n for n, _ in c.most_common(4)])
                      for th, c in host.items()},
        groups=[dict(name=k[0], stream=k[1], call=k[2], host_thread=k[3],
                     count=len(v), first_us=min(v), last_us=max(v))
                for k, v in sorted(groups.items(), key=str)])


def _device_ms(torch, fn, reps=20):
    """Device time (ms) per call of `fn`: its kernels' summed self time
    over `reps` calls, divided by `reps`; and those kernels by name with
    their time (us) and launches per call."""
    rows, _ = _device_kernels(torch, fn, reps)
    return sum(r[0] for r in rows) / reps / 1e3, \
        [dict(kernel=k[:120], us=us / reps, calls=n / reps)
         for us, k, n in rows]


# the port's hand-written kernels among the profiler's kernel names (they
# live in an anonymous namespace; cuDNN's own "..._flash_bprop_..." do not)
_PORT_KERNEL = re.compile(r"::(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel"
                          r"|conv1x1_stats(?:_tc)?_kernel"
                          r"|stats_reduce_kernel"
                          r"|mxt_nms_(?:count|mask|scan)_kernel)\b")


def _profile(torch, fn, reps, top=8, **row):
    """Device time per kernel name over `reps` calls of `fn`; `busy_share`
    is that time over the host wall of the profiled window (profiler
    overhead included).  Emits `row` with the breakdown: the `top`
    kernels, and every kernel of the port's own (`port_kernels`) with
    their sum and share.  Returns {port kernel: launches per call}."""
    rows, wall_us = _device_kernels(torch, fn, reps)
    device_us = sum(r[0] for r in rows)
    port = [dict(kernel=k[:100], us=us, calls=n) for us, k, n in rows
            if _PORT_KERNEL.search(k)]
    port_us = sum(r["us"] for r in port)
    _emit(dict(row, wall_us=wall_us, device_us=device_us,
               busy_share=device_us / wall_us,
               top=[dict(kernel=k[:100], us=us, calls=n,
                         share=us / device_us if device_us else None)
                    for us, k, n in rows[:top]],
               port_kernels=port, port_kernels_us=port_us,
               port_kernels_share=port_us / device_us if device_us
               else None))
    return _port_kernel_calls(rows, reps)


def phase_profile(torch, net, x, forwards=3):
    """Device time by kernel over `forwards` full-bucket forwards."""
    with torch.inference_mode():
        _profile(torch, lambda: net(x), forwards, phase="profile",
                 batch=list(x.shape), forwards=forwards)


def _grad_tolerance(torch, ref, dt):
    """Elementwise bound on a flash gradient against its plain version.
    f32: BWD_TOL of the largest |ref|.  16-bit: both round P and dS at the
    same points and round the outputs to the dtype, and sums in another
    f32 order can tip a rounding by one ulp; within `_low_tolerance`."""
    if dt == "float32":
        return torch.full_like(ref, BWD_TOL * ref.abs().max().item())
    return _low_tolerance(ref, dt)


def phase_kernel_bwd(torch, att):
    """The dQ and dK/dV kernels against their plain versions over CASES;
    returns their rows by case."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    rows = {}
    for BH, T, d, dt, causal in CASES:
        dtype = getattr(torch, dt)
        q, k, v, do = (torch.randn(BH, T, d, device="cuda", generator=gen)
                       .mul_(0.5).to(dtype) for _ in range(4))
        scale = 1.0 / math.sqrt(d)
        out, lse = att.flash_attention_fwd(q, k, v, scale, causal)
        dq, delta = att.flash_attention_bwd_dq(q, k, v, out, lse, do, scale,
                                               causal)
        dk, dv = att.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale,
                                             causal)
        torch.cuda.synchronize()
        # each kernel against its plain version on the same inputs
        ref_dq, ref_delta = att.flash_attention_bwd_dq_plain(
            q, k, v, out, lse, do, scale, causal)
        ref_dk, ref_dv = att.flash_attention_bwd_dkv_plain(
            q, k, v, do, lse, delta, scale, causal)
        errs, ratios = {}, {}
        for name, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                               ("dv", dv, ref_dv)):
            ref = ref.float()
            diff = (got.float() - ref).abs()
            errs[name] = diff.max().item()
            ratios[name] = (diff / _grad_tolerance(torch, ref, dt)).max() \
                .item()
        err_delta = (delta - ref_delta).abs().max().item()
        tol_delta = BWD_TOL * max(ref_delta.abs().max().item(), 1.0)
        ok = max(ratios.values()) <= 1.0 and err_delta <= tol_delta
        dq_ms = _time_ms(torch, lambda: att.flash_attention_bwd_dq(
            q, k, v, out, lse, do, scale, causal))
        dkv_ms = _time_ms(torch, lambda: att.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, scale, causal))
        dq_plain_ms = _time_ms(torch, lambda: att.flash_attention_bwd_dq_plain(
            q, k, v, out, lse, do, scale, causal))
        dkv_plain_ms = _time_ms(
            torch, lambda: att.flash_attention_bwd_dkv_plain(
                q, k, v, do, lse, delta, scale, causal))
        # device time of the pair and of each kernel, as the library's is
        # read below
        pair_device_ms, pair_kernels = _device_ms(
            torch, lambda: att.flash_attention_bwd(q, k, v, out, lse, do,
                                                   scale, causal))
        dq_device_ms, dkv_device_ms = (
            sum(r["us"] for r in pair_kernels if name in r["kernel"]) / 1e3
            for name in ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"))
        # the library's backward alone: scaled_dot_product_attention's
        # forward once on 4-D (1, BH, T, d) views with its graph kept, then
        # autograd.grad over it again and again, timed by CUDA events and
        # by the device time of the kernels it launches.  It gives dq, dk
        # and dv together, so both kernel rows carry the same value.
        q4, k4, v4 = (t[None].detach().requires_grad_() for t in (q, k, v))
        out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                              scale=scale)
        do4 = do[None]

        def sdpa_bwd():
            return torch.autograd.grad(out4, (q4, k4, v4), do4,
                                       retain_graph=True)

        library_events_ms = _time_ms(torch, sdpa_bwd)
        library_ms, library_kernels = _device_ms(torch, sdpa_bwd)
        del out4
        row = dict(phase="kernel_bwd", BH=BH, T=T, d=d, dtype=dt,
                   causal=causal, err=errs, err_over_bound=ratios,
                   err_delta=err_delta, tol_delta=tol_delta, ok=ok,
                   dq_ms=dq_ms, dkv_ms=dkv_ms, dq_plain_ms=dq_plain_ms,
                   dkv_plain_ms=dkv_plain_ms, dq_device_ms=dq_device_ms,
                   dkv_device_ms=dkv_device_ms, pair_device_ms=pair_device_ms,
                   library_ms=library_ms, library_events_ms=library_events_ms,
                   library="sdpa backward alone (autograd.grad over a kept "
                           "graph, 4-D views), device time",
                   library_kernels=library_kernels[:4],
                   pair_device_over_library=pair_device_ms / library_ms,
                   **_dq_bound(BH, T, d, dt, causal),
                   **_dkv_bound(BH, T, d, dt, causal))
        _emit(row)
        _check(ok, "flash backward disagrees with its plain version: %r"
               % (row,))
        rows[BH, T, d, dt, causal] = row
    return rows


def _train_step(mx, net, loss_fn, trainer, inputs, y):
    """One training step of `net` on the tuple `inputs` (batch first)."""
    with mx.autograd.record():
        loss = loss_fn(net(*inputs), y)
    mx.autograd.backward(loss)
    trainer.step(inputs[0].shape[0])
    return loss.detach()


def _port_kernel_calls(rows, reps=1):
    """{port kernel: launches per call} among profiler rows [(us, name,
    calls)] of `reps` calls."""
    calls = collections.Counter()
    for _, k, n in rows:
        m = _PORT_KERNEL.search(k)
        if m:
            calls[m.group(1)] += n
    return {k: n // reps for k, n in calls.items()}


def _profiled_counts(kernels):
    """A step's launches of (fwd, dq, dkv, conv) among the profiler's
    kernel names (`_port_kernel_calls`); the names do not tell a causal
    launch."""
    conv = kernels.get("conv1x1_stats_tc_kernel", 0) \
        + kernels.get("conv1x1_stats_kernel", 0)
    return tuple(kernels.get(k, 0) for k in (
        "flash_fwd_kernel", "flash_bwd_dq_kernel",
        "flash_bwd_dkv_kernel")) + (conv,)


def _host_trace(torch, fn, top=15):
    """Host time by op over one call of `fn` (torch.profiler, CPU
    activity only): self CPU time of the `top` ops and the total."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                  reverse=True)
    return dict(wall_us=wall_us,
                self_cpu_us=sum(e.self_cpu_time_total for e in rows),
                top=[dict(op=e.key[:80], self_cpu_us=e.self_cpu_time_total,
                          calls=e.count) for e in rows[:top]])


def _graph_counts(blocks, trainer):
    """What the hybridized blocks' cached programs and the Trainer did."""
    graphs = [b._cached_graph for b in blocks
              if b.__dict__.get("_cached_graph") is not None]
    return dict(captures=sum(g.captures for g in graphs) + trainer.captures,
                replays=sum(g.replays for g in graphs) + trainer.replays,
                eager_calls=sum(g.eager_calls for g in graphs),
                eager_updates=trainer.eager_updates)


def _mode_run(torch, mx, att, cs, build, step, hybrid, units, trace=False):
    """TRAIN_WARMUP + TRAIN_STEPS steps of `build()` = (net, loss block,
    trainer), eager or hybridized as bench.py hybridizes (the net with
    static_alloc and static_shape, the loss plain): step ms (CUDA
    events), `units` per s, peak memory, the losses and final
    parameters, what the captured programs did, and PROFILE_STEPS
    profiled steps (busy share, each port kernel's launches per step,
    the 8 costliest kernels, every kernel's name); with `trace` one
    step's host time by op.  The launch counters (`_COUNT_KEYS`, conv,
    nms) count what the wrappers issue: over the whole run (`launches`),
    per warm-up step and per timed step.  A hybridized step launches
    through its graphs, which no wrapper sees, so its launches per step
    are the profiler's."""
    from incubator_mxnet_tpu_torch.ops import nms
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net, head, trainer = build()
    if hybrid:
        net.hybridize(static_alloc=True, static_shape=True)
        head.hybridize()
    else:
        net.hybridize(active=False)
    run = lambda: step(net, head, trainer)      # noqa: E731
    _reset_counts(att)                  # the path starts here
    cs.conv1x1_stats_launches = nms.nms_launches = 0
    counts = lambda: _all_counts(att) + (  # noqa: E731
        cs.conv1x1_stats_launches, nms.nms_launches)

    def counted():
        before, programs = counts(), _graph_counts((net, head), trainer)
        out = run()
        after = _graph_counts((net, head), trainer)
        return out, tuple(a - b for a, b in zip(counts(), before)), {
            k: after[k] - programs[k] for k in after}
    warmup = [counted()[1:] for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    warm = _graph_counts((net, head), trainer)
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(TRAIN_STEPS + 1)]
    losses, per_step = [], []
    t0 = time.perf_counter()
    events[0].record()
    for i in range(TRAIN_STEPS):
        loss, launched, _ = counted()
        losses.append(loss)
        events[i + 1].record()
        per_step.append(launched)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    timed = _graph_counts((net, head), trainer)
    peak = torch.cuda.max_memory_allocated()
    params = [p.detach().cpu().clone() for p in trainer._params]
    rows, wall_us = _device_kernels(torch, run, PROFILE_STEPS)
    keys = _COUNT_KEYS + ("conv", "nms")
    launches = dict(zip(keys, counts()))    # the path ends here
    device_us = sum(r[0] for r in rows)
    kernels = _port_kernel_calls(rows, PROFILE_STEPS)
    port_us = collections.Counter()
    for us, k, _ in rows:
        m = _PORT_KERNEL.search(k)
        if m:
            port_us[m.group(1)] += us / PROFILE_STEPS
    out = dict(
        mode="hybridized" if hybrid else "eager",
        step_ms=[events[i].elapsed_time(events[i + 1])
                 for i in range(TRAIN_STEPS)],
        units_per_s=TRAIN_STEPS * units / wall, wall_s=wall,
        max_memory_allocated=peak,
        losses=[v.item() for v in losses], launches=launches,
        warmup_steps=[dict(launches=dict(zip(keys, c)), programs=g)
                      for c, g in warmup],
        launches_per_step=[dict(zip(keys, c)) for c in sorted(set(per_step))],
        profiled_launches_per_step=dict(
            zip(("fwd", "dq", "dkv", "conv"), _profiled_counts(kernels)),
            nms=kernels.get("mxt_nms_mask_kernel", 0)),
        profile=dict(steps=PROFILE_STEPS, wall_us=wall_us,
                     device_us=device_us, busy_share=device_us / wall_us,
                     kernels_per_step=sum(n for _, _, n in rows)
                     / PROFILE_STEPS,
                     # torch's depthwise convolution kernels (MobileNet's
                     # grouped 3x3s), by name
                     depthwise_us_per_step=sum(
                         us for us, k, _ in rows if "conv_depthwise" in k)
                     / PROFILE_STEPS,
                     port_kernels=kernels,
                     port_kernel_us_per_step=dict(port_us),
                     top=[dict(kernel=k[:80], us=us, calls=n)
                          for us, k, n in rows[:8]]),
        programs=dict(after_warmup=warm, during_timed_steps={
            k: timed[k] - warm[k] for k in timed}))
    out["step_ms_median"] = statistics.median(out["step_ms"])
    out["kernel_names"] = sorted({k[:100] for _, k, _ in rows})
    if trace:
        out["host_trace"] = _host_trace(torch, run)
    return out, params, (per_step, warmup)


def _ab_compare(torch, eager, hyb, rerun):
    """Hybridized against eager on the same weights and data: bit for bit,
    or else within the eager rerun's own spread (`rerun()` gives its
    losses and parameters).  Returns the row and whether it holds."""
    (e, e_params), (h, h_params) = eager, hyb
    same_losses = e["losses"] == h["losses"]
    same_params = all(_same_bits(torch, a, b)
                      for a, b in zip(e_params, h_params))
    row = dict(losses_bit_equal=same_losses, params_bit_equal=same_params,
               kernels_only_eager=sorted(set(e["kernel_names"])
                                         - set(h["kernel_names"])),
               kernels_only_hybridized=sorted(set(h["kernel_names"])
                                              - set(e["kernel_names"])))
    if same_losses and same_params:
        return row, True

    def dist(a, b):
        return (max(abs(x - y) for x, y in zip(a[0]["losses"],
                                               b[0]["losses"])),
                max((x.float() - y.float()).abs().max().item()
                    for x, y in zip(a[1], b[1])))
    r = rerun()
    row.update(hybridized_vs_eager=dist(hyb, eager),
               eager_rerun_spread=dist(r, eager))
    ok = all(a <= b for a, b in zip(row["hybridized_vs_eager"],
                                     row["eager_rerun_spread"]))
    return row, ok


def _summary(run):
    return {k: run[k] for k in ("step_ms_median", "units_per_s",
                                "max_memory_allocated")} | dict(
        busy_share=run["profile"]["busy_share"])


def phase_hybridize(torch, mx, att, cs, name, build, step, units,
                    per_step_want, trace=False):
    """`name` eager and hybridized in one process, from the same weights
    and data (`_mode_run`), held against each other (`_ab_compare`).
    Each kernel's launches a step must be `per_step_want` (in the order
    of `_COUNT_KEYS` + ("conv", "nms")): in the profiler's names over the
    profiled steps, in both modes; by the counters in every eager timed
    step and in the hybridized warm-up step that captured, whose
    wrappers issued the launches its graphs hold (the causal ones too,
    which the profiler's names do not tell); and by the counters, in no
    hybridized timed step, which only replay.  Returns the hybridized
    run."""
    eager = _mode_run(torch, mx, att, cs, build, step, False, units, trace)
    hyb = _mode_run(torch, mx, att, cs, build, step, True, units)
    row, ok = _ab_compare(
        torch, eager[:2], hyb[:2],
        lambda: _mode_run(torch, mx, att, cs, build, step, False, units)[:2])
    _emit(dict(phase=name + "_hybridize", eager=eager[0],
               hybridized=hyb[0], compare=row,
               speedup=eager[0]["step_ms_median"] / hyb[0]["step_ms_median"],
               memory_ratio=hyb[0]["max_memory_allocated"]
               / eager[0]["max_memory_allocated"]))
    _check(ok, "%s: the hybridized run differs from the eager one by more "
           "than the eager rerun's spread: %r" % (name, row))
    want = tuple(per_step_want)
    totals = want[:3] + want[-2:]
    for run in (eager[0], hyb[0]):
        measured = tuple(run["profiled_launches_per_step"].values())
        _check(measured == totals,
               "%s (%s): a profiled step launched %r (fwd, dq, dkv, conv, "
               "nms), not %r" % (name, run["mode"], measured, totals))
        _check(all(n > 0 for n, w in zip(run["launches"].values(), want)
                   if w),
               "%s (%s): a kernel of the path was not launched: %r"
               % (name, run["mode"], run["launches"]))
        _check(all(math.isfinite(v) for v in run["losses"]),
               "%s (%s): non-finite loss" % (name, run["mode"]))
    per_step, _ = eager[2]
    _check(all(c == want for c in per_step),
           "%s (eager) launched %r a step (%s, conv, nms), not %r"
           % (name, sorted(set(per_step)), ", ".join(_COUNT_KEYS), want))
    per_step, warmup = hyb[2]
    zero = (0,) * len(want)
    _check(all(c == zero for c in per_step),
           "%s (hybridized): a timed step ran a kernel wrapper: %r"
           % (name, sorted(set(per_step))))
    captured = [c for c, g in warmup
                if g["captures"] and not g["eager_calls"]]
    _check(captured == [want],
           "%s (hybridized): the capturing warm-up steps issued %r, not "
           "one step of %r" % (name, captured, want))
    timed = hyb[0]["programs"]["during_timed_steps"]
    _check(timed["captures"] == 0 and timed["eager_updates"] == 0
           and timed["eager_calls"] == 0 and timed["replays"] > 0,
           "%s: the hybridized timed steps did not only replay: %r"
           % (name, timed))
    hyb[0]["compare"] = row
    return hyb[0]


def _tf32(torch, x, nearest=True):
    """x cut to TF32 (10 mantissa bits): to nearest, or truncated as the
    tensor cores read an f32 operand."""
    bits = x.contiguous().view(torch.int32)
    return (((bits + 0x1000) if nearest else bits) & ~0x1fff) \
        .view(torch.float32)


@contextlib.contextmanager
def _plain_backward(att, matmul, forward=False):
    """The attention backward (with `forward`, the forward too) taken by
    its plain version on the card, its products through `matmul`; the
    kernels again on exit."""
    saved = att.flash_attention_fwd, att.flash_attention_bwd, att._matmul
    att.flash_attention_bwd, att._matmul = att.flash_attention_bwd_plain, \
        matmul
    if forward:
        att.flash_attention_fwd = att.flash_attention_fwd_plain
    try:
        yield
    finally:
        att.flash_attention_fwd, att.flash_attention_bwd, att._matmul = \
            saved


@contextlib.contextmanager
def _launch_dtypes(att):
    """Yields a list that gets (kernel, operand dtype) for each flash
    kernel launch inside the block: the wrappers' CUDA entries are
    wrapped, their launch counters untouched."""
    log = []
    names = ("_flash_fwd_cuda", "_flash_bwd_dq_cuda", "_flash_bwd_dkv_cuda")
    saved = [getattr(att, n) for n in names]

    def logged(name, fn):
        def call(q, *args):
            log.append((name, str(q.dtype)))
            return fn(q, *args)
        return call

    for name, fn in zip(names, saved):
        setattr(att, name, logged(name, fn))
    try:
        yield log
    finally:
        for name, fn in zip(names, saved):
            setattr(att, name, fn)


# the three kernels' launch counters, then the causal ones among them
_COUNT_KEYS = ("fwd", "dq", "dkv", "fwd_causal", "dq_causal", "dkv_causal")
_COUNTERS = ("flash_fwd_launches", "flash_bwd_dq_launches",
             "flash_bwd_dkv_launches", "flash_fwd_causal_launches",
             "flash_bwd_dq_causal_launches", "flash_bwd_dkv_causal_launches")


def _all_counts(att):
    return tuple(getattr(att, name) for name in _COUNTERS)


def _reset_counts(att):
    for name in _COUNTERS:
        setattr(att, name, 0)


def phase_train(torch, mx, att):
    """BERT-base MLM training through the port's entry points; returns
    the launches of each kernel over the timed steps."""
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, 30522, (TRAIN_BATCH, SEQ)).astype(np.int32)
    labels = rs.randint(0, 30522, (TRAIN_BATCH, SEQ)).astype(np.float32)
    mx.random.seed(0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = mx.models.bert_base(dropout=0.0, output_hidden=True,
                              device="cuda:0")
    head = mx.models.FusedMLMCELoss(30522, 768, device="cuda:0")
    layers = len(net.encoder.layers)
    params = dict(net.collect_params())
    params.update({"loss." + n: p for n, p in head.collect_params().items()})
    trainer = mx.gluon.Trainer(params, "adam", {"learning_rate": 1e-4})

    # parity: one batch-1 step's loss and gradients against a CPU copy
    cpu_net = mx.models.bert_base(dropout=0.0, output_hidden=True,
                                  device="cpu")
    cpu_net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    cpu_head = mx.models.FusedMLMCELoss(30522, 768, device="cpu")
    cpu_head.load_state_dict({k: v.cpu()
                              for k, v in head.state_dict().items()})
    cpu_params = dict(cpu_net.collect_params())
    cpu_params.update({"loss." + n: p
                       for n, p in cpu_head.collect_params().items()})
    x1, y1 = torch.from_numpy(tokens[:1]), torch.from_numpy(labels[:1])
    with mx.autograd.record():
        ref_loss = cpu_head(cpu_net(x1), y1)
    mx.autograd.backward(ref_loss)
    gmax = max(p.grad.abs().max().item() for p in cpu_params.values())

    def worst_grad():
        worst, worst_name = 0.0, None
        for name, p in params.items():
            ref = cpu_params[name].grad
            err = (p.grad.cpu() - ref).abs().max().item()
            ratio = err / max(ref.abs().max().item(), 1e-3 * gmax)
            if ratio >= worst:
                worst, worst_name = ratio, name
        return worst, worst_name

    # the same gradients with the attention backward's plain version in
    # place of the kernels, its products in f32 and in one TF32 product
    # each: the kernels' share of the distance to the CPU copy, and what
    # TRAIN_TOL makes of 1xTF32 products.  Read only, held to nothing.
    plain_bwd = {}
    for label, matmul in (("f32", torch.matmul),
                          ("1xtf32", lambda a, b: torch.matmul(
                              _tf32(torch, a), _tf32(torch, b)))):
        with _plain_backward(att, matmul):
            with mx.autograd.record():
                loss = head(net(x1.cuda()), y1.cuda())
            mx.autograd.backward(loss)
        plain_bwd[label] = dict(zip(("worst_grad_err_over_scale",
                                     "worst_grad"), worst_grad()))
    loss1 = _train_step(mx, net, head, trainer, (x1.cuda(),), y1.cuda())
    loss_err = (loss1.cpu() - ref_loss.detach()).abs().max().item()
    worst, worst_name = worst_grad()
    del cpu_net, cpu_head, cpu_params, ref_loss

    x = torch.from_numpy(tokens).cuda()
    y = torch.from_numpy(labels).cuda()
    for _ in range(TRAIN_WARMUP):
        _train_step(mx, net, head, trainer, (x,), y)
    torch.cuda.synchronize()
    _reset_counts(att)                  # the main path starts here
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(TRAIN_STEPS + 1)]
    losses, per_step = [], []
    t0 = time.perf_counter()
    events[0].record()
    for i in range(TRAIN_STEPS):
        before = _all_counts(att)[:3]
        losses.append(_train_step(mx, net, head, trainer, (x,), y).mean())
        events[i + 1].record()
        per_step.append(tuple(a - b for a, b in
                              zip(_all_counts(att)[:3], before)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _all_counts(att)[:3]     # the main path ends here
    step_ms = [events[i].elapsed_time(events[i + 1])
               for i in range(TRAIN_STEPS)]
    losses = [v.item() for v in losses]
    _emit(dict(phase="train", model="bert_base", dtype="float32",
               batch=TRAIN_BATCH, seq=SEQ, optimizer="adam", lr=1e-4,
               parity=dict(batch=1, loss_max_abs_err=loss_err,
                           loss_mean=loss1.mean().item(),
                           worst_grad_err_over_scale=worst,
                           worst_grad=worst_name, tol=TRAIN_TOL,
                           tensors=len(params), plain_backward=plain_bwd),
               warmup_steps=TRAIN_WARMUP, steps=TRAIN_STEPS,
               step_ms=step_ms, step_ms_median=statistics.median(step_ms),
               wall_s=wall,
               tokens_per_s=TRAIN_STEPS * TRAIN_BATCH * SEQ / wall,
               losses=losses,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               launches=dict(zip(("fwd", "dq", "dkv"), launches)),
               launches_per_step=sorted(set(per_step))))
    # the loss is a forward quantity: held as the served logits are
    _check(loss_err <= SERVE_TOL, "batch-1 loss differs from the CPU copy "
           "by %g > %g" % (loss_err, SERVE_TOL))
    _check(worst <= TRAIN_TOL, "gradient of %s differs from the CPU copy: "
           "%g of its scale > %g" % (worst_name, worst, TRAIN_TOL))
    _check(all(math.isfinite(v) for v in losses),
           "non-finite training loss: %r" % (losses,))
    _check(all(c == (layers,) * 3 for c in per_step),
           "a training step launched (fwd, dq, dkv) %r, not %d each"
           % (per_step, layers))
    _profile(torch, lambda: _train_step(mx, net, head, trainer, (x,), y), 1,
             top=16, phase="train_profile", batch=[TRAIN_BATCH, SEQ],
             steps=1)
    return dict(zip(("fwd", "dq", "dkv"), launches))


@contextlib.contextmanager
def _upcast_vocab_route(mx):
    """The fused CE's vocab GEMMs with bf16 operands upcast to f32 on the
    card (the CPU's route) in place of cuBLAS's bf16 GEMM with an f32
    output; the card route again on exit."""
    nn = mx.ops.nn
    route = nn._low_precision_card
    nn._low_precision_card = lambda a, b: False
    try:
        yield
    finally:
        nn._low_precision_card = route


def _vocab_routes(torch, mx, head, y):
    """One forward and backward of the fused vocab CE at the step's shape
    (BF16_BATCH x SEQ rows of bf16 hidden states, random from seed 0)
    by each route: CUDA-event ms (tens of ms a call, so the host's share
    is small), and the routes' largest loss and dh differences."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    h = torch.randn(y.numel(), head.weight.shape[1], device="cuda",
                    generator=gen).to(torch.bfloat16).requires_grad_()
    w, b, lab = head.weight, head.bias, y.reshape(-1)

    def fwd_bwd():
        loss = mx.ops.nn.fused_linear_softmax_ce(h, w, b, lab)
        return (loss,) + torch.autograd.grad(loss.sum(), (h, w, b))

    out = {}
    for route in ("bf16_f32_out", "upcast_f32"):
        ctx = _upcast_vocab_route(mx) if route == "upcast_f32" \
            else contextlib.nullcontext()
        with ctx:
            res = fwd_bwd()
            ms = _time_ms(torch, fwd_bwd, reps=3, rounds=3)
        out[route] = dict(ms=ms, res=res)
    a, c = out["bf16_f32_out"].pop("res"), out["upcast_f32"].pop("res")
    out["loss_max_abs_diff"] = (a[0] - c[0]).abs().max().item()
    out["dh_max_abs_diff"] = (a[1].float() - c[1].float()).abs().max().item()
    out["flops"] = 3 * 2.0 * y.numel() * w.shape[0] * w.shape[1]
    return out


def phase_train_bf16(torch, mx, att):
    """BERT-base MLM training in bf16 through the port's entry points, as
    bench.py's run_bert (net.cast and loss.cast to bf16, Adam lr 1e-4,
    batch 16 x 512); returns the launches of each kernel over the timed
    steps."""
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, 30522, (BF16_BATCH, SEQ)).astype(np.int32)
    labels = rs.randint(0, 30522, (BF16_BATCH, SEQ)).astype(np.float32)
    mx.random.seed(0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = mx.models.bert_base(dropout=0.0, output_hidden=True,
                              device="cuda:0").cast("bfloat16")
    head = mx.models.FusedMLMCELoss(30522, 768, device="cuda:0") \
        .cast("bfloat16")
    layers = len(net.encoder.layers)
    params = dict(net.collect_params())
    params.update({"loss." + n: p for n, p in head.collect_params().items()})
    trainer = mx.gluon.Trainer(params, "adam", {"learning_rate": 1e-4})

    # parity: a batch-1 step against an f32 CPU copy holding the same
    # bf16-valued weights (bf16 is exact in f32), by the kernels and by
    # the plain route (every flash kernel's plain version on the card)
    cpu_net = mx.models.bert_base(dropout=0.0, output_hidden=True,
                                  device="cpu")
    cpu_net.load_state_dict({k: v.float().cpu()
                             for k, v in net.state_dict().items()})
    cpu_head = mx.models.FusedMLMCELoss(30522, 768, device="cpu")
    cpu_head.load_state_dict({k: v.float().cpu()
                              for k, v in head.state_dict().items()})
    x1, y1 = torch.from_numpy(tokens[:1]), torch.from_numpy(labels[:1])
    with mx.autograd.record():
        ref_hidden = cpu_net(x1)
        ref_loss = cpu_head(ref_hidden, y1)
    mx.autograd.backward(ref_loss)
    ref_hidden = ref_hidden.detach()
    ref_grads = {n: p.grad for n, p in cpu_net.collect_params().items()}
    ref_grads.update({"loss." + n: p.grad
                      for n, p in cpu_head.collect_params().items()})
    top = max(r.abs().max().item() for r in ref_grads.values())
    scales = {n: max(r.abs().max().item(), 1e-3 * top)
              for n, r in ref_grads.items()}
    scales["hidden"] = ref_hidden.abs().max().item()

    def route_errors(loss, hidden):
        err = _scaled_err({n: p.grad for n, p in params.items()}, ref_grads)
        err["hidden"] = (hidden.float().cpu() - ref_hidden).abs().max() \
            .item() / scales["hidden"]
        worst = max((n for n in err if n != "hidden"), key=err.get)
        return err, dict(loss_max_abs_err=(loss.float().cpu()
                                           - ref_loss.detach()).abs().max()
                         .item(),
                         hidden_err_over_scale=err["hidden"],
                         worst_grad_err_over_scale=err[worst],
                         worst_grad=worst)

    def keep_hidden(h, y):
        hidden.append(h.detach())
        return head(h, y)

    hidden = []
    with _plain_backward(att, torch.matmul, forward=True):
        with mx.autograd.record():
            loss = keep_hidden(net(x1.cuda()), y1.cuda())
        mx.autograd.backward(loss)
    plain_err, plain = route_errors(loss, hidden.pop())
    loss1 = _train_step(mx, net, keep_hidden, trainer, (x1.cuda(),),
                        y1.cuda())
    kern_err, kern = route_errors(loss1, hidden.pop())
    # each tensor's kernel-route error over its gate (ok <= 1)
    over = {n: kern_err[n] / (BF16_ROUTE_FACTOR * plain_err[n]
                              + _bf16_ulp_share(scales[n]))
            for n in kern_err}
    worst_over = max(over, key=over.get)
    del cpu_net, cpu_head, ref_grads, ref_loss, ref_hidden

    x = torch.from_numpy(tokens).cuda()
    y = torch.from_numpy(labels).cuda()
    for _ in range(TRAIN_WARMUP):
        _train_step(mx, net, head, trainer, (x,), y)
    torch.cuda.synchronize()
    _reset_counts(att)                  # the main path starts here
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(TRAIN_STEPS + 1)]
    losses, per_step = [], []
    with _launch_dtypes(att) as dtypes:
        t0 = time.perf_counter()
        events[0].record()
        for i in range(TRAIN_STEPS):
            before = _all_counts(att)
            losses.append(_train_step(mx, net, head, trainer, (x,), y)
                          .mean())
            events[i + 1].record()
            per_step.append(tuple(a - b for a, b in
                                  zip(_all_counts(att), before)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(zip(_COUNT_KEYS, _all_counts(att)))  # the path ends here
    step_ms = [events[i].elapsed_time(events[i + 1])
               for i in range(TRAIN_STEPS)]
    losses = [v.item() for v in losses]
    peak = torch.cuda.max_memory_allocated()
    vocab = _vocab_routes(torch, mx, head, y)
    per_step_want = (layers,) * 3 + (0,) * 3
    launch_dtypes = sorted(set(dtypes))
    _emit(dict(phase="train_bf16", model="bert_base", dtype="bfloat16",
               batch=BF16_BATCH, seq=SEQ, optimizer="adam", lr=1e-4,
               parity=dict(batch=1, kernels=kern, plain_route=plain,
                           route_factor=BF16_ROUTE_FACTOR,
                           loss_floor=BF16_LOSS_FLOOR,
                           loss_mean=loss1.mean().item(),
                           tensors=len(over),
                           worst_over_gate=over[worst_over],
                           worst_over_gate_tensor=worst_over,
                           # [tensor, e_kernels / gate, e_kernels, e_plain]
                           over_gate_top=[
                               [n, over[n], kern_err[n], plain_err[n]]
                               for n in sorted(over, key=over.get)[-6:]]),
               warmup_steps=TRAIN_WARMUP, steps=TRAIN_STEPS,
               step_ms=step_ms, step_ms_median=statistics.median(step_ms),
               wall_s=wall,
               tokens_per_s=TRAIN_STEPS * BF16_BATCH * SEQ / wall,
               losses=losses, max_memory_allocated=peak,
               launches=launches, launch_dtypes=launch_dtypes,
               launches_per_step=[dict(zip(_COUNT_KEYS, c))
                                  for c in sorted(set(per_step))],
               vocab_projection=vocab))
    _check(kern["loss_max_abs_err"] <= BF16_ROUTE_FACTOR
           * plain["loss_max_abs_err"] + BF16_LOSS_FLOOR,
           "bf16 batch-1 loss by the kernels differs from the CPU copy by "
           "%g, more than %g x the plain route's %g + %g"
           % (kern["loss_max_abs_err"], BF16_ROUTE_FACTOR,
              plain["loss_max_abs_err"], BF16_LOSS_FLOOR))
    _check(over[worst_over] <= 1.0,
           "bf16 %s by the kernels differs from the CPU copy by %g of its "
           "scale, more than %g x the plain route's %g + one bf16 ulp"
           % (worst_over, kern_err[worst_over], BF16_ROUTE_FACTOR,
              plain_err[worst_over]))
    _check(all(math.isfinite(v) for v in losses),
           "non-finite bf16 training loss: %r" % (losses,))
    _check(all(c == per_step_want for c in per_step),
           "a bf16 training step launched %r (%s), not %r"
           % (per_step, ", ".join(_COUNT_KEYS), per_step_want))
    _check({dt for _, dt in launch_dtypes} == {"torch.bfloat16"},
           "the bf16 step launched kernel instances %r" % (launch_dtypes,))
    # the loss is a forward quantity: the two routes held as served logits
    _check(vocab["loss_max_abs_diff"] <= SERVE_TOL, "the vocab projection's "
           "routes disagree on the loss by %g" % vocab["loss_max_abs_diff"])
    _profile(torch, lambda: _train_step(mx, net, head, trainer, (x,), y), 1,
             top=16, phase="train_bf16_profile", batch=[BF16_BATCH, SEQ],
             steps=1)
    return launches


def rcnn_conv_shapes(cs):
    """(N, C, HW, O, sites): the pointwise conv + BatchNorm pairs of one
    train_rcnn step.  `cs.RESNET_CONV_SHAPES` lists stages 1-3 first and
    stage 4's three shapes last: stages 1-3 run on the RCNN_BATCH
    images' stride-4, 8 and 16 maps (224 x 224's 3136, 784 and 196 become
    HW 30000, 7500 and 1900 at 600 x 800; each stride-2 layer rounds up),
    stage 4 on the sampled rois' 14 x 14 ROIAlign output (HW 196, then 49
    after its strided 3 x 3), as at 224 x 224."""
    H, W = RCNN_HW
    maps = {hw: -(-H // 2 ** s) * -(-W // 2 ** s)
            for hw, s in ((3136, 2), (784, 3), (196, 4))}
    return ([(RCNN_BATCH, C, maps[HW], O, k)
             for C, HW, O, k in cs.RESNET_CONV_SHAPES[:-3]]
            + [(RCNN_ROIS * RCNN_BATCH, C, HW, O, k)
               for C, HW, O, k in cs.RESNET_CONV_SHAPES[-3:]])


def conv_cases(cs):
    """kernel_conv cases (N, C, HW, O, dtype): the resnet50_v1b step's
    shapes in bf16 (`cs.RESNET_CONV_SHAPES`), train_mobilenet's
    (`cs.MOBILENET_V2_CONV_SHAPES`: C 16, 24 and 144 on the CUDA cores,
    O 16, 24 and 32 in partial column tiles) and train_rcnn's
    (`rcnn_conv_shapes`: partial column tiles at HW 30000, the CUDA-core
    instance at HW 7500 and 1900), the tool's five shapes in f32, ragged
    shapes in both dtypes, and the f16 instances at three step shapes
    (rows, and both slab tilings) and a ragged one."""
    return ([(RESNET_BATCH, C, HW, O, "bfloat16")
             for C, HW, O, _ in cs.RESNET_CONV_SHAPES]
            + [(RESNET_BATCH, C, HW, O, "bfloat16")
               for C, HW, O, _ in cs.MOBILENET_V2_CONV_SHAPES]
            + [(N, C, HW, O, "bfloat16")
               for N, C, HW, O, _ in rcnn_conv_shapes(cs)]
            + [(RESNET_BATCH, C, HW, O, "float32") for C, HW, O in (
                (64, 3136, 256), (128, 784, 512), (256, 196, 1024),
                (512, 49, 2048), (256, 3136, 64))]
            + [(3, 72, 49, 80, "bfloat16"), (3, 72, 49, 80, "float32"),
               (5, 17, 33, 65, "bfloat16"), (1, 1, 1, 1, "float32")]
            + [(RESNET_BATCH, C, HW, O, "float16") for C, HW, O in (
                (64, 3136, 256), (1024, 196, 256), (512, 49, 2048))]
            + [(5, 17, 33, 65, "float16")])


def conv_y_errors(torch, cs, x, w, y, ref_y):
    """The largest error of y over its elementwise tolerance (ok <= 1).
    f32 {kernel}: |y - plain| against 1e-4 of the largest |plain|.  bf16
    and f16 {kernel, plain}: |y - e| of the kernel's y and of the plain
    version's against `cs.conv1x1_y_bound`."""
    if x.dtype == torch.float32:
        tol = 1e-4 * ref_y.abs().max().item()
        return dict(kernel=(y - ref_y).abs().max().item() / max(tol, 1e-30))
    exact, bound = cs.conv1x1_y_bound(x, w)
    bound.clamp_(min=1e-300)
    return {name: ((got.double() - exact).abs() / bound).max().item()
            for name, got in (("kernel", y), ("plain", ref_y))}


def conv_check(torch, cs, x, w):
    """The kernel on x (N, C, HW), w (O, C) against its plain version:
    the instance it takes, y's largest error and its errors over their
    bound (`conv_y_errors`), the sums' errors (Σy over sqrt(N·HW·Σy²),
    Σy² relative), each within CONV_SUM_TOL, and whether all hold."""
    N, C, HW = x.shape
    path = cs.conv1x1_stats_path(N, C, HW, w.shape[0], x.dtype)
    y, s1, s2 = cs.fused_conv1x1_stats(x, w)
    torch.cuda.synchronize()
    ref_y, ref_s1, ref_s2 = cs.fused_conv1x1_stats_plain(x, w)
    y_over_bound = conv_y_errors(torch, cs, x, w, y, ref_y)
    rel_s1 = ((s1 - ref_s1).abs()
              / (N * HW * ref_s2).sqrt().clamp_min(1e-30)).max().item()
    rel_s2 = ((s2 - ref_s2).abs() / ref_s2.clamp_min(1e-30)).max().item()
    return dict(path=path,
                err_y=(y.float() - ref_y.float()).abs().max().item(),
                y_over_bound=y_over_bound, rel_err_s1=rel_s1,
                rel_err_s2=rel_s2, tol_sums=CONV_SUM_TOL,
                ok=(max(y_over_bound.values()) <= 1.0
                    and rel_s1 <= CONV_SUM_TOL and rel_s2 <= CONV_SUM_TOL))


def _conv_bound(N, C, HW, O, dtype):
    """Roofline of the fused call: the 2·N·HW·C·O product operations; x
    and w read, y written, and the two (O,) f32 sums written once."""
    elem = 4 if dtype == "float32" else 2
    flops = 2.0 * N * HW * C * O
    nbytes = (N * C * HW + O * C + N * O * HW) * elem + 2 * 4.0 * O
    return _roofline(flops, nbytes, dtype)


def phase_kernel_conv(torch, cs):
    """The fused 1x1-conv + statistics kernel against its plain version
    over `conv_cases`; returns the per-step sums over the launch sites
    of a bf16 resnet50_v1b step ("resnet", 33), a mobilenet_v2_1_0 step
    ("mobilenet", 34) and a train_rcnn step ("rcnn", 33)."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    sites = dict(
        resnet={(RESNET_BATCH, C, HW, O): k
                for C, HW, O, k in cs.RESNET_CONV_SHAPES},
        mobilenet={(RESNET_BATCH, C, HW, O): k
                   for C, HW, O, k in cs.MOBILENET_V2_CONV_SHAPES},
        rcnn={(N, C, HW, O): k for N, C, HW, O, k in rcnn_conv_shapes(cs)})
    steps = {p: dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                     library_conv_ms=0.0, bound_ms=0.0, max_abs_err=0.0,
                     launches=0, paths={}) for p in sites}
    bound_by_ms = {p: dict(bytes=0.0, operations=0.0) for p in sites}
    for N, C, HW, O, dt in conv_cases(cs):
        dtype = getattr(torch, dt)
        x = torch.randn(N, C, HW, device="cuda", generator=gen).to(dtype)
        w = (torch.randn(O, C, device="cuda", generator=gen) * 0.05) \
            .to(dtype)
        check = conv_check(torch, cs, x, w)
        ms = _time_ms(torch, lambda: cs.fused_conv1x1_stats(x, w))
        plain_ms = _time_ms(torch, lambda: cs.fused_conv1x1_stats_plain(
            x, w))
        # the library route: cuDNN's 1x1 convolution, then the two f32
        # sums of its (rounded) output, and the convolution alone;
        # yardsticks the port never calls
        x4, w4 = x.reshape(N, C, HW, 1), w.reshape(O, C, 1, 1)

        def library():
            y4 = F.conv2d(x4, w4).float()
            return y4.sum(dim=(0, 2, 3)), y4.square().sum(dim=(0, 2, 3))

        library_ms = _time_ms(torch, library)
        library_conv_ms = _time_ms(torch, lambda: F.conv2d(x4, w4))
        bound = _conv_bound(N, C, HW, O, dt)
        row = dict(phase="kernel_conv", name="conv1x1_stats", N=N, C=C,
                   HW=HW, O=O, dtype=dt, **check, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   library="F.conv2d 1x1 + two f32 sums",
                   library_conv_ms=library_conv_ms, **bound,
                   bound_share=bound["bound_ms"] / ms)
        _emit(row)
        _check(row["ok"], "conv1x1_stats disagrees with its plain version "
               "or the exact product: %r" % (row,))
        path = row["path"]
        for p, by_shape in sites.items():
            k = by_shape.get((N, C, HW, O)) if dt == "bfloat16" else None
            if not k:
                continue
            _check(p != "resnet" or path.startswith("tensor_cores"),
                   "the step shape %r takes the %s instance, not the "
                   "tensor cores" % ((C, HW, O), path))
            step = steps[p]
            for key in ("ms", "plain_ms", "library_ms", "library_conv_ms",
                        "bound_ms"):
                step[key] += k * row[key]
            step["max_abs_err"] = max(step["max_abs_err"], row["err_y"])
            step["paths"][path] = step["paths"].get(path, 0) + k
            bound_by_ms[p][row["bound_by"]] += k * row["bound_ms"]
            step["launches"] += k
    for p, want in (("resnet", RESNET_SITES),
                    ("mobilenet", MOBILENET_SITES), ("rcnn", RCNN_SITES)):
        _check(steps[p]["launches"] == want, "the %s step's conv shapes "
               "cover %d launch sites, not %d"
               % (p, steps[p]["launches"], want))
        # what bounds most of the step's summed bound
        steps[p]["bound_by"] = max(bound_by_ms[p], key=bound_by_ms[p].get)
    _emit(dict(phase="kernel_conv_steps", **steps))
    return steps


def _resnet_grads(mx, net, loss_fn, x, y):
    """One forward and backward in training mode: the per-example loss,
    {name: gradient} of the trainable tensors and {name: value} of the
    running statistics (which the forward updated), on the CPU."""
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    mx.autograd.backward(loss)
    params = net.collect_params()
    # copies: the next forward updates the running statistics in place
    return (loss.detach().cpu(),
            {n: p.grad.detach().cpu().clone() for n, p in params.items()
             if p.requires_grad},
            {n: p.detach().cpu().clone() for n, p in params.items()
             if not p.requires_grad})


def _small_resnet_parity(torch, mx, loss_fn):
    """A small ResNet v1b (9 fused pairs) through one f32 step of batch 4
    on the card against a CPU copy: every gradient within TRAIN_TOL of
    its scale."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    kw = dict(SMALL_RESNET)
    args = (resnet.BottleneckV1, kw.pop("layers"), kw.pop("channels"))
    net = resnet.ResNetV1(*args, device="cuda:0", **kw)
    cpu = resnet.ResNetV1(*args, device="cpu", **kw)
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(4, 3, 32, 32).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 10, 4).astype(np.float32))
    _copy_to_cpu(mx, net, cpu, x[:1])
    loss, grads, _ = _resnet_grads(mx, net, loss_fn, x.cuda(), y.cuda())
    ref_loss, ref_grads, _ = _resnet_grads(mx, cpu, loss_fn, x, y)
    err = _scaled_err(grads, ref_grads)
    worst = max(err, key=err.get)
    return dict(batch=4, image=[3, 32, 32], gradients=len(err),
                loss_max_abs_err=(loss - ref_loss).abs().max().item(),
                worst_grad_err_over_scale=err[worst], worst_grad=worst,
                grad_tol=TRAIN_TOL)


def _copy_to_cpu(mx, net, cpu_net, x):
    """Give `cpu_net` the parameters of `net` (on the card).  Both stems
    take their input width from the first forward's images, as in the
    JAX package, so one inference forward of `x` on each completes
    them first; in inference the running statistics stay as they are."""
    with mx.autograd.pause():
        net(x.to(next(net.parameters()).device))
        cpu_net(x)
    cpu_net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})


def _bf16_ulp_share(scale):
    """One bf16 ulp at `scale` (8 significant bits) over `scale`."""
    return 2.0 ** (math.floor(math.log2(scale)) - 7) / scale


def _scaled_err(got, ref):
    """{name: max-abs error over max-abs value}, each value floored at
    1e-3 of the largest among `ref`."""
    top = max(r.abs().max().item() for r in ref.values())
    return {n: (got[n].cpu() - r).abs().max().item()
            / max(r.abs().max().item(), 1e-3 * top) for n, r in ref.items()}


def phase_train_resnet(torch, mx, cs):
    """resnet50_v1b training through the port's entry points, as
    bench.py's run_cachedop; returns the conv kernel's launches over the
    timed steps, the step median, images/s and peak memory, and the
    parameters' {name: shape}."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import \
        resnet50_v1b
    rs = np.random.RandomState(0)
    images = rs.randn(RESNET_BATCH, 3, 224, 224).astype(np.float32)
    labels = rs.randint(0, 1000, RESNET_BATCH).astype(np.float32)
    mx.random.seed(0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = resnet50_v1b(classes=1000, device="cuda:0")
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    params = net.collect_params()
    trainer = mx.gluon.Trainer(params, "sgd", {
        "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})

    # parity: one batch-2 f32 step against a CPU copy (TF32 is off)
    cpu_net = resnet50_v1b(classes=1000, device="cpu")
    x2 = torch.from_numpy(images[:RESNET_PARITY_BATCH])
    y2 = torch.from_numpy(labels[:RESNET_PARITY_BATCH])
    _copy_to_cpu(mx, net, cpu_net, x2[:1])
    shapes = {n: list(p.shape) for n, p in params.items()}
    loss2, grads, running = _resnet_grads(mx, net, loss_fn, x2.cuda(),
                                          y2.cuda())
    trainer.step(RESNET_PARITY_BATCH)
    ref_loss, ref_grads, ref_running = _resnet_grads(mx, cpu_net, loss_fn,
                                                     x2, y2)
    # the CPU copy against itself, its input scaled by 1 + 2**-22
    _, spread_grads, _ = _resnet_grads(mx, cpu_net, loss_fn,
                                       x2 * (1.0 + 2.0 ** -22), y2)
    loss_err = (loss2.cpu() - ref_loss).abs().max().item()
    grad_err = _scaled_err(grads, ref_grads)
    spread = _scaled_err(spread_grads, ref_grads)
    run_err = _scaled_err(running, ref_running)
    worst_grad = max(grad_err, key=grad_err.get)
    worst_run = max(run_err, key=run_err.get)
    grad_max = dict(card=grad_err[worst_grad], cpu_spread=max(spread.values()))
    grad_median = dict(card=statistics.median(grad_err.values()),
                       cpu_spread=statistics.median(spread.values()))
    del cpu_net, ref_grads, spread_grads, grads, running, ref_running
    small = _small_resnet_parity(torch, mx, loss_fn)

    x = torch.from_numpy(images).cuda().to(torch.bfloat16)  # bench.py's cast
    y = torch.from_numpy(labels).cuda()
    for _ in range(TRAIN_WARMUP):
        _train_step(mx, net, loss_fn, trainer, (x,), y)
    torch.cuda.synchronize()
    cs.conv1x1_stats_launches = 0       # the main path starts here
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(TRAIN_STEPS + 1)]
    losses, per_step = [], []
    t0 = time.perf_counter()
    events[0].record()
    for i in range(TRAIN_STEPS):
        before = cs.conv1x1_stats_launches
        losses.append(_train_step(mx, net, loss_fn, trainer, (x,), y).mean())
        events[i + 1].record()
        per_step.append(cs.conv1x1_stats_launches - before)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cs.conv1x1_stats_launches    # the main path ends here
    step_ms = [events[i].elapsed_time(events[i + 1])
               for i in range(TRAIN_STEPS)]
    losses = [v.item() for v in losses]
    summary = dict(step_ms_median=statistics.median(step_ms),
                   images_per_s=TRAIN_STEPS * RESNET_BATCH / wall,
                   max_memory_allocated=torch.cuda.max_memory_allocated())
    _emit(dict(phase="train_resnet", model="resnet50_v1b", classes=1000,
               dtype="bfloat16", batch=RESNET_BATCH, image=[3, 224, 224],
               optimizer="sgd", lr=0.1, momentum=0.9, wd=1e-4,
               parity=dict(batch=RESNET_PARITY_BATCH, dtype="float32",
                           loss_max_abs_err=loss_err,
                           loss_mean=loss2.mean().item(),
                           grad_err_over_scale_max=grad_max,
                           grad_err_over_scale_median=grad_median,
                           worst_grad=worst_grad,
                           spread_factor=RESNET_SPREAD_FACTOR,
                           within_train_tol=sum(
                               v <= TRAIN_TOL for v in grad_err.values()),
                           gradients=len(grad_err),
                           worst_running_err_over_scale=run_err[worst_run],
                           worst_running=worst_run, running_tol=RUNNING_TOL,
                           running_tensors=len(run_err),
                           small_resnet=small),
               warmup_steps=TRAIN_WARMUP, steps=TRAIN_STEPS,
               step_ms=step_ms, **summary, wall_s=wall, losses=losses,
               conv1x1_stats_launches=launches,
               launches_per_step=sorted(set(per_step))))
    _check(loss_err <= SERVE_TOL, "batch-2 loss differs from the CPU copy "
           "by %g > %g" % (loss_err, SERVE_TOL))
    _check(len(grad_err) == 161, "%d trainable tensors, not 161"
           % len(grad_err))
    for name, v in (("largest", grad_max), ("median", grad_median)):
        _check(v["card"] <= RESNET_SPREAD_FACTOR * v["cpu_spread"],
               "the %s gradient error against the CPU copy, %g of its "
               "scale, exceeds %g x the CPU copy's own rounding spread %g"
               % (name, v["card"], RESNET_SPREAD_FACTOR, v["cpu_spread"]))
    _check(small["worst_grad_err_over_scale"] <= TRAIN_TOL,
           "small ResNet gradient differs from the CPU copy: %r" % (small,))
    _check(small["loss_max_abs_err"] <= 1e-4,
           "small ResNet loss differs from the CPU copy: %r" % (small,))
    _check(run_err[worst_run] <= RUNNING_TOL, "running statistic %s differs "
           "from the CPU copy: %g of its scale > %g"
           % (worst_run, run_err[worst_run], RUNNING_TOL))
    _check(all(math.isfinite(v) for v in losses),
           "non-finite training loss: %r" % (losses,))
    _check(all(c == RESNET_SITES for c in per_step),
           "a training step launched the conv kernel %r times, not %d"
           % (per_step, RESNET_SITES))
    _profile(torch, lambda: _train_step(mx, net, loss_fn, trainer, (x,), y),
             1, top=16, phase="train_resnet_profile",
             batch=[RESNET_BATCH, 3, 224, 224], steps=1)
    return dict(summary, launches=launches, shapes=shapes)


def _cosine_lr(k):
    """The lr of the k-th update under GLUON_LR's warmup and cosine,
    written out here apart from `lr_scheduler`."""
    base, final = GLUON_LR["base_lr"], GLUON_LR["final_lr"]
    warm, begin = GLUON_LR["warmup_steps"], GLUON_LR["warmup_begin_lr"]
    if k < warm:
        return begin + (base - begin) * k / warm
    return final + (base - final) * (1 + math.cos(
        math.pi * (k - warm) / (GLUON_MAX_UPDATE - warm))) / 2


def _resnet_batch(torch):
    """train_resnet's batch: 128 images from RandomState(0), cast to
    bf16 as bench.py casts them, and their labels, on the card."""
    rs = np.random.RandomState(0)
    images = rs.randn(RESNET_BATCH, 3, 224, 224).astype(np.float32)
    labels = rs.randint(0, 1000, RESNET_BATCH).astype(np.float32)
    return (torch.from_numpy(images).cuda().to(torch.bfloat16),
            torch.from_numpy(labels).cuda())


def _gluon_trainer(mx, net, nag=GLUON_NAG):
    """No weight decay on beta, gamma and bias; NAG (`nag`'s lr, momentum
    and wd) with a fresh warmup-cosine scheduler."""
    net.collect_params(GLUON_NO_WD).setattr("wd_mult", 0.0)
    sched = mx.lr_scheduler.CosineScheduler(max_update=GLUON_MAX_UPDATE,
                                            **GLUON_LR)
    return mx.gluon.Trainer(net.collect_params(), "nag",
                            dict(nag, lr_scheduler=sched))


def _gluon_net(mx, seen=None, name="resnet50_v1b"):
    """`name` (resnet50_v1b) as a Gluon user builds it: `get_model` with
    every parameter waiting for `initialize`, then MSRAPrelu on the card
    (the widths the net is not given wait for the first forward).
    `seen` gets the names of the parameters without data before and
    after `initialize`."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    from incubator_mxnet_tpu_torch.gluon.parameter import is_deferred

    def waiting():
        return [n for n, p in net.collect_params().items()
                if is_deferred(p)]
    mx.random.seed(0)
    net = get_model(name, classes=1000)
    before = waiting()
    net.initialize(mx.init.MSRAPrelu(), ctx=mx.gpu(0))
    if seen is not None:
        seen.update(before_initialize=before, after_initialize=waiting())
    net.hybridize(static_alloc=True, static_shape=True)
    return net


def _gluon_step(mx, net, trainer, loss_fn, x, y):
    """record → loss → autograd.backward → trainer.step; (out, the
    batch's mean loss on the card)."""
    with mx.autograd.record():
        out = net(x)
        loss = loss_fn(out, y)
    mx.autograd.backward(loss)
    trainer.step(x.shape[0])
    return out, loss.detach().mean()


def _gluon_build(mx, name="resnet50_v1b", nag=GLUON_NAG):
    """The Gluon loop's (net, loss, trainer) for model `name`, fresh from
    seed 0."""
    def build():
        net = _gluon_net(mx, name=name)
        return net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), \
            _gluon_trainer(mx, net, nag)
    return build


def _raw(torch, t):
    """A tensor's bits as integers (-0.0 and NaNs compare by bits)."""
    return t.detach().contiguous().view(
        {1: torch.uint8, 2: torch.int16, 4: torch.int32,
         8: torch.int64}[t.element_size()])


def _same_bits(torch, a, b):
    """Whether two tensors, or optimizer states (tensors, None or
    tuples of them), hold the same bits in the same dtype and shape."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same_bits(torch, u, v)
                                        for u, v in zip(a, b))
    if a is None or b is None:
        return a is b
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(_raw(torch, a.cpu()), _raw(torch, b.cpu())))


def _cpu_state(state):
    if isinstance(state, (tuple, list)):
        return type(state)(_cpu_state(s) for s in state)
    return None if state is None else state.detach().cpu().clone()


def _wd_check(torch, trainer, scratch):
    """One extra NAG step with every gradient and momentum zeroed: a
    wd_mult 0 parameter (and each running statistic) stays bit for bit,
    a wd_mult 1 weight w moves by its weight decay alone, which NAG's
    look-ahead applies as lr wd (1 + momentum) w, within one f32 ulp of
    w.  Parameters and states are restored after it."""
    keep = [p.detach().clone() for p in trainer._params]
    path = os.path.join(scratch, "wd.states")
    trainer.save_states(path)
    k = trainer.optimizer.num_update + 1
    for p in trainer._params:
        if p.grad is not None:
            p.grad.zero_()
    for state in trainer._updater.states.values():
        state.zero_()
    trainer.step(RESNET_BATCH)
    lr = trainer.learning_rate          # the scheduler's at update k
    wd, mom = GLUON_NAG["wd"], GLUON_NAG["momentum"]
    still = moved = 0
    worst = 0.0
    for p, w0 in zip(trainer._params, keep):
        if not p.requires_grad or p.wd_mult == 0:
            _check(torch.equal(_raw(torch, p), _raw(torch, w0)),
                   "a parameter without weight decay moved in the "
                   "weight-decay step")
            still += 1
            continue
        w = w0.double()
        want = w - lr * wd * (1 + mom) * w
        ulp = torch.pow(2.0, torch.floor(torch.log2(
            w.abs().clamp_min(2.0 ** -126))) - 23)
        worst = max(worst, ((p.detach().double() - want).abs() / ulp)
                    .max().item())
        moved += 1
    with torch.no_grad():
        for p, w0 in zip(trainer._params, keep):
            p.copy_(w0)
    trainer.load_states(path)
    return dict(update=k, lr=lr, lr_expected=_cosine_lr(k),
                unchanged=still, decayed=moved, worst_err_over_ulp=worst,
                restored_num_update=trainer.optimizer.num_update)


class _LogLines(logging.Handler):
    """Collects the messages logged at INFO and above while installed."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        root = logging.getLogger()
        self._level = root.level
        root.setLevel(logging.INFO)
        root.addHandler(self)
        return self

    def __exit__(self, *exc):
        root = logging.getLogger()
        root.removeHandler(self)
        root.setLevel(self._level)


def phase_train_resnet_gluon(torch, mx, cs, resnet_row):
    """resnet50_v1b trained through the Gluon core surface as a user
    writes the loop, hybridized; returns the conv kernel's launches over
    run A.  Run A: 2 warm-up and 10 timed steps, saved after timed step
    GLUON_SAVE_AT; its weight-decay step after them.  Run R: A's save
    loaded into fresh objects, timed steps 6-10 again.  Run B: A again
    from the same seed, for the spread of the card's own losses.  The
    first warm-up step runs eagerly and the second captures, so the
    counters see 33 launches in each and none in the timed steps, which
    replay; the profiled step's kernel names must show the 33."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    from incubator_mxnet_tpu_torch.gluon.parameter import is_deferred
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    x, y = _resnet_batch(torch)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    loss_fn.hybridize()
    os.makedirs(BUILD, exist_ok=True)
    scratch = tempfile.TemporaryDirectory(dir=BUILD)
    p_file, s_file, b_file = (os.path.join(scratch.name, f)
                              for f in ("a.params", "a.states", "b.params"))

    # run A
    seen = {}
    net = _gluon_net(mx, seen)
    params = net.collect_params()
    trainer = _gluon_trainer(mx, net)
    metric = mx.metric.CompositeEvalMetric([mx.metric.Accuracy(),
                                            mx.metric.TopKAccuracy(5)])
    speed = mx.callback.Speedometer(RESNET_BATCH, frequent=5)
    cs.conv1x1_stats_launches = 0       # the main path starts here
    _gluon_step(mx, net, trainer, loss_fn, x, y)
    warm_steps = [cs.conv1x1_stats_launches]
    still_waiting = [n for n, p in params.items() if is_deferred(p)]
    shapes = {n: list(p.shape) for n, p in params.items()}
    for _ in range(TRAIN_WARMUP - 1):
        before = cs.conv1x1_stats_launches
        _gluon_step(mx, net, trainer, loss_fn, x, y)
        warm_steps.append(cs.conv1x1_stats_launches - before)
    torch.cuda.synchronize()
    speed(_BatchEnd(0, 0, metric, None))    # the first interval starts
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(TRAIN_STEPS)]
    losses, per_step, lrs = [], [], []
    save_s = 0.0
    t0 = time.perf_counter()
    with _LogLines() as log:
        for k in range(1, TRAIN_STEPS + 1):
            before = cs.conv1x1_stats_launches
            events[k - 1][0].record()
            out, loss = _gluon_step(mx, net, trainer, loss_fn, x, y)
            events[k - 1][1].record()
            per_step.append(cs.conv1x1_stats_launches - before)
            losses.append(loss)
            lrs.append(dict(num_update=trainer.optimizer.num_update,
                            lr=trainer.learning_rate))
            torch.cuda.set_sync_debug_mode("error")
            try:
                metric.update([y], [out])
            finally:
                torch.cuda.set_sync_debug_mode(0)
            speed(_BatchEnd(0, k, metric, None))
            if k == GLUON_SAVE_AT:
                torch.cuda.synchronize()
                t = time.perf_counter()
                net.save_parameters(p_file)
                trainer.save_states(s_file)
                opt = trainer.optimizer
                snap = dict(params={n: p.detach().cpu().clone()
                                    for n, p in params.items()},
                            states={i: _cpu_state(s) for i, s in
                                    trainer._updater.states.items()},
                            num_update=opt.num_update,
                            counts=dict(opt._index_update_count),
                            sched=dict(vars(opt.lr_scheduler)))
                save_s += time.perf_counter() - t
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - save_s
    launches = cs.conv1x1_stats_launches    # the main path ends here
    peak = torch.cuda.max_memory_allocated()
    step_ms = [s.elapsed_time(e) for s, e in events]
    losses = [v.item() for v in losses]
    wd = _wd_check(torch, trainer, scratch.name)

    # save and resume: the file and the states, bit for bit
    net2 = get_model("resnet50_v1b", classes=1000)
    net2.load_parameters(p_file, ctx=mx.gpu(0))
    got = net2.collect_params()
    same_params = sum(_same_bits(torch, got[n], t)
                      for n, t in snap["params"].items() if n in got)
    trainer2 = _gluon_trainer(mx, net2)
    trainer2.load_states(s_file)
    opt2 = trainer2.optimizer
    states2 = trainer2._updater.states
    same_states = sum(i in states2 and _same_bits(torch, states2[i], t)
                      for i, t in snap["states"].items())
    restored = dict(num_update=opt2.num_update == snap["num_update"],
                    counts=opt2._index_update_count == snap["counts"],
                    scheduler=vars(opt2.lr_scheduler) == snap["sched"],
                    states_on_parameter_devices=all(
                        s.device == trainer2._params[i].device
                        for i, s in states2.items()))
    # bf16: net2 cast, saved, loaded into a fresh bf16 net
    net2_bf16 = get_model("resnet50_v1b", classes=1000)
    net2_bf16.load_parameters(p_file, ctx=mx.gpu(0))
    net2_bf16.cast("bfloat16")
    net2_bf16.save_parameters(b_file)
    net3 = get_model("resnet50_v1b", classes=1000)
    net3.cast("bfloat16")
    net3.load_parameters(b_file, ctx=mx.gpu(0))
    ref_bf16 = net2_bf16.collect_params()
    same_bf16 = sum(_same_bits(torch, p, ref_bf16[n])
                    and p.dtype == torch.bfloat16
                    for n, p in net3.collect_params().items())
    del net2_bf16, net3, ref_bf16

    # run R: timed steps GLUON_SAVE_AT + 1 .. TRAIN_STEPS from the save
    net2.hybridize(static_alloc=True, static_shape=True)
    resumed = [_gluon_step(mx, net2, trainer2, loss_fn, x, y)[1]
               for _ in range(TRAIN_STEPS - GLUON_SAVE_AT)]
    resumed = [v.item() for v in resumed]
    del net2, trainer2, states2
    # run B: A again, uninterrupted
    net_b = _gluon_net(mx)
    trainer_b = _gluon_trainer(mx, net_b)
    rerun = [_gluon_step(mx, net_b, trainer_b, loss_fn, x, y)[1]
             for _ in range(TRAIN_WARMUP + TRAIN_STEPS)]
    rerun = [v.item() for v in rerun[TRAIN_WARMUP:]]
    del net_b, trainer_b
    scratch.cleanup()
    tail = slice(GLUON_SAVE_AT, TRAIN_STEPS)
    spread = max(abs(a - b) for a, b in zip(losses[tail], rerun[tail]))
    resume_err = max(abs(a - r) for a, r in zip(losses[tail], resumed))

    want_lrs = [dict(num_update=TRAIN_WARMUP + k,
                     lr=_cosine_lr(TRAIN_WARMUP + k))
                for k in range(1, TRAIN_STEPS + 1)]
    lr_err = max(abs(g["lr"] - w["lr"]) / w["lr"]
                 for g, w in zip(lrs, want_lrs))
    summary = dict(step_ms_median=statistics.median(step_ms),
                   images_per_s=TRAIN_STEPS * RESNET_BATCH / wall,
                   max_memory_allocated=peak)
    _emit(dict(phase="train_resnet_gluon", model="resnet50_v1b",
               classes=1000, dtype="bfloat16", batch=RESNET_BATCH,
               image=[3, 224, 224], init="MSRAPrelu", no_wd=GLUON_NO_WD,
               optimizer="nag", **GLUON_NAG,
               lr_scheduler=dict(GLUON_LR, kind="CosineScheduler",
                                 max_update=GLUON_MAX_UPDATE),
               warmup_steps=TRAIN_WARMUP, steps=TRAIN_STEPS,
               step_ms=step_ms, **summary, wall_s=wall, save_s=save_s,
               train_resnet=dict((k, resnet_row[k]) for k in summary),
               losses=losses, conv1x1_stats_launches=launches,
               warmup_launches=warm_steps,
               launches_per_step=sorted(set(per_step)),
               deferred_before_initialize=len(seen["before_initialize"]),
               deferred_after_initialize=seen["after_initialize"],
               deferred_after_forward=len(still_waiting),
               parameters=len(shapes), lrs=lrs, lr_max_rel_err=lr_err,
               speedometer=log.lines, wd_check=wd,
               save_after_step=GLUON_SAVE_AT,
               params_bit_equal=[same_params, len(snap["params"])],
               states_bit_equal=[same_states, len(snap["states"])],
               bf16_params_bit_equal=same_bf16, restored=restored,
               resumed_losses=resumed, rerun_losses=rerun[tail],
               rerun_spread=spread, resume_err=resume_err))
    _check(warm_steps == [RESNET_SITES] * TRAIN_WARMUP
           and not any(per_step),
           "the Gluon loop's wrappers launched the conv kernel %r times in "
           "the warm-up steps (eager, then the capture), not %d each, and "
           "%r times in the replayed timed steps, not 0"
           % (warm_steps, RESNET_SITES, sorted(set(per_step))))
    _check(len(seen["before_initialize"]) == len(shapes)
           and seen["after_initialize"] == ["features.0.weight"]
           and not still_waiting,
           "parameters without data: %d of %d before initialize, %r "
           "after it, %r after the first forward"
           % (len(seen["before_initialize"]), len(shapes),
              seen["after_initialize"], still_waiting))
    _check(shapes == resnet_row["shapes"], "the Gluon loop's parameters "
           "differ from resnet50_v1b(classes=1000, device='cuda:0')'s in "
           "names or shapes")
    _check([g["num_update"] for g in lrs] ==
           [w["num_update"] for w in want_lrs] and lr_err <= 1e-12,
           "lr sequence %r, not %r" % (lrs, want_lrs))
    _check(wd["decayed"] == 54 and wd["unchanged"] == 267 - 54
           and wd["worst_err_over_ulp"] <= 1.0
           and abs(wd["lr"] - wd["lr_expected"]) <= 1e-12 * wd["lr"]
           and wd["restored_num_update"] == wd["update"] - 1,
           "weight decay per parameter: %r" % (wd,))
    _check(same_params == len(snap["params"]) == len(shapes),
           "load_parameters gave back %d of %d tensors bit for bit"
           % (same_params, len(snap["params"])))
    _check(same_bf16 == len(shapes), "the bf16 round trip gave back %d "
           "of %d tensors bit for bit" % (same_bf16, len(shapes)))
    _check(same_states == len(snap["states"]) == 161
           and all(restored.values()),
           "load_states: %d of %d states bit for bit, %r"
           % (same_states, len(snap["states"]), restored))
    _check(all(math.isfinite(v) for v in losses + resumed + rerun),
           "non-finite loss in the Gluon loop")
    _check(resume_err <= spread, "the resumed losses differ from the "
           "uninterrupted run's by %g, more than the spread %g of two "
           "uninterrupted runs" % (resume_err, spread))
    _check(len(log.lines) == TRAIN_STEPS // 5, "Speedometer logged %r"
           % (log.lines,))
    kernels = _profile(
        torch, lambda: _gluon_step(mx, net, trainer, loss_fn, x, y), 1,
        top=16, phase="train_resnet_gluon_profile",
        batch=[RESNET_BATCH, 3, 224, 224], steps=1)
    _check(_profiled_counts(kernels) == (0, 0, 0, RESNET_SITES),
           "a replayed Gluon-loop step launched %r of the port's kernels, "
           "not %d conv" % (kernels, RESNET_SITES))
    return launches


# resnet50_v1b fed from a JPEG RecordIO file (bench.py's run_cachedop,
# its input-fed half: _ensure_rec's corpus, the decode service, the device
# feed with uint8 on the wire, the normalize captured into the step)
FED_IMAGES = 512
FED_IMAGE_HW = (256, 313)
FED_QUALITY = 90
FED_RESIZE = 256
FED_SHAPE = (3, 224, 224)
FED_EPOCHS = 2              # timed: 2 x 4 steps of 128
FED_DECODE_EPOCHS = 3       # the decode service alone, timed
FED_HOST_IMAGES = 16        # decode and resize timed on the parent
FED_COPY_STEPS = 4          # the feed against a synchronous copy
FED_MEAN, FED_STD = 127.5, 64.0


def _fed_planted(mx):
    """Wrong transforms the fed parity check must refuse: mean and std
    swapped, and the mean off by half a pixel level."""
    return dict(
        planted_swap=mx.io.normalize_transform(FED_STD, FED_MEAN, "float32"),
        planted_mean_off_half=mx.io.normalize_transform(
            FED_MEAN + 0.5, FED_STD, "float32"))


def _fed_corpus(mx, path, n=FED_IMAGES, hw=FED_IMAGE_HW):
    """bench.py's `_ensure_rec` corpus, written by the port's recordio:
    `n` images of hw x 3 random uint8 from RandomState(0), JPEG quality
    90 (the RAWI frame where the host has no PIL), label i % 1000.
    Returns the codec."""
    try:
        import PIL              # noqa: F401
        codec = "jpeg"
    except ImportError:
        codec = "rawi"
    rs = np.random.RandomState(0)
    rec = mx.recordio.MXRecordIO(path, "w")
    for i in range(n):
        img = rs.randint(0, 255, hw + (3,), dtype=np.uint8)
        rec.write(mx.recordio.pack_img(
            mx.recordio.IRHeader(0, float(i % 1000), i, 0), img,
            quality=FED_QUALITY))
    rec.close()
    return codec


def _fed_decode_alone(mx, path, batch, workers, epochs=FED_DECODE_EPOCHS):
    """The decode service with no consumer: its start-up (the workers'
    handshake), a first epoch whose batches are copied out and returned
    (host (data, label) pairs), then `epochs` epochs timed, together and
    each on its own: an epoch is one batch a worker, too short a window
    to read a steady rate from."""
    t0 = time.perf_counter()
    svc = mx.io.DecodeService(path, batch, FED_SHAPE, workers=workers,
                              resize=FED_RESIZE, rand_crop=True,
                              rand_mirror=True, shuffle=True, dtype="uint8")
    svc.reset()
    startup = time.perf_counter() - t0
    try:
        host = [(sb.data.copy(), sb.label[:, 0].copy()) for sb in svc]
        n, per_epoch = 0, []
        t0 = time.perf_counter()
        for _ in range(epochs):
            e0, m = time.perf_counter(), 0
            for sb in svc:
                m += sb.count
            per_epoch.append(m / (time.perf_counter() - e0))
            n += m
        wall = time.perf_counter() - t0
    finally:
        svc.close()
    return dict(io_workers=svc.workers, cpu_count=os.cpu_count(),
                start_method=mx.config.get("MXNET_IO_MP_START"),
                startup_s=startup, epochs=epochs, images=n, wall_s=wall,
                images_per_s=n / wall,
                epoch_images_per_s=per_epoch), host


def _fed_host_costs(path, n=FED_HOST_IMAGES):
    """ms per image, on the parent's one thread, of a worker's decode
    stages over the file's first `n` records: the JPEG decode, the numpy
    resize of the short side to FED_RESIZE, and the whole
    `decode_record` (crop, mirror and the CHW uint8 copy too)."""
    from incubator_mxnet_tpu_torch.io import decode_service as ds
    from incubator_mxnet_tpu_torch.io import recordio
    rec = recordio.MXRecordIO(path, "r")
    raws = [rec.read() for _ in range(n)]
    rec.close()
    t0 = time.perf_counter()
    imgs = [recordio.unpack_img(r)[1] for r in raws]
    t1 = time.perf_counter()
    for img in imgs:
        scale = FED_RESIZE / min(img.shape[:2])
        ds._resize_linear(img, (int(round(img.shape[1] * scale)),
                                int(round(img.shape[0] * scale))))
    t2 = time.perf_counter()
    for j, r in enumerate(raws):
        ds.decode_record(r, FED_SHAPE, FED_RESIZE, True, True,
                         ds._record_rng(0, 0, 0, 0, j))
    t3 = time.perf_counter()
    return dict(images=n, decode_ms=(t1 - t0) / n * 1e3,
                resize_ms=(t2 - t1) / n * 1e3,
                decode_record_ms=(t3 - t2) / n * 1e3)


def _fed_busy(torch, fn, steps):
    """The card's busy share over `steps` calls of `fn`: the device time of
    every kernel, copy and fill torch.profiler records over the host wall
    of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    host = {ev.key for ev in events if ev.device_type != DeviceType.CUDA}
    device_us = sum(ev.self_device_time_total for ev in events
                    if ev.device_type == DeviceType.CUDA
                    and ev.key not in host)
    return dict(steps=steps, wall_us=wall_us, device_us=device_us,
                busy_share=device_us / wall_us)


def _fed_expected(path, ids, batch, workers, epoch=0, seed=0):
    """The host decode of the batch whose record ids are `ids`:
    `decode_record` of each record with the worker's per-record RNG, the
    (wid, seq) found from `shard_records`.  (None, None) when no worker's
    shard holds that batch."""
    from incubator_mxnet_tpu_torch.io import decode_service as ds
    from incubator_mxnet_tpu_torch.io import recordio
    offsets = recordio.list_record_offsets(path)
    for wid in range(workers):
        order = ds.shard_records(len(offsets), workers, wid, epoch=epoch,
                                 shuffle=True, seed=seed, batch_size=batch)
        for seq, s in enumerate(range(0, len(order), batch)):
            if order[s:s + batch].tolist() != ids:
                continue
            out = []
            with open(path, "rb") as fh:
                for j, ri in enumerate(ids):
                    fh.seek(offsets[ri])
                    rng = ds._record_rng(seed, epoch, wid, seq, j)
                    out.append(ds.decode_record(
                        recordio.read_record(fh), FED_SHAPE, FED_RESIZE,
                        True, True, rng, dtype="uint8")[0])
            return np.stack(out), (wid, seq)
    return None, None


def _fed_step(mx, net, loss_fn, trainer, data, label):
    """A user's step on NDArrays: record, loss, backward, update; the
    batch's mean loss (on the card)."""
    with mx.autograd.record():
        loss = loss_fn(net(data), label)
    loss.backward()
    trainer.step(data.shape[0])
    return loss._data.detach().mean()


def _fed_state(torch, net, trainer):
    """The tensors a step reads and writes: every parameter (running
    statistics included) and every optimizer state."""
    from incubator_mxnet_tpu_torch.optimizer.optimizer import _map_state
    out = [p for p in net.collect_params().values()]
    for i in sorted(trainer._updater.states):
        _map_state(out.append, trainer._updater.states[i])
    return out


def _fed_against_copy(torch, mx, net, loss_fn, trainer, host):
    """The same uint8 batches two ways from the same state: through a
    DeviceFeed (pinned staging, its side stream, the consumer waiting on
    its events) and by a synchronous `.cuda()` copy, into the same
    hybridized net; their losses and the state after must be equal bit
    for bit."""
    state = _fed_state(torch, net, trainer)
    start = [t.detach().clone() for t in state]

    def restore():
        with torch.no_grad():
            for t, s in zip(state, start):
                t.copy_(s)

    def run(batches):
        restore()
        losses = [_fed_step(mx, net, loss_fn, trainer, d, l)
                  for d, l in batches]
        torch.cuda.synchronize()
        return ([v.item() for v in losses],
                [t.detach().cpu().clone() for t in state])
    fed = run(mx.io.DeviceFeed(host, ctx=mx.gpu(0)))
    copied = run([(mx.nd.NDArray(torch.from_numpy(d).cuda()),
                   mx.nd.NDArray(torch.from_numpy(l).cuda()))
                  for d, l in host])
    same = sum(_same_bits(torch, a, b) for a, b in zip(fed[1], copied[1]))
    return dict(steps=len(host), losses_feed=fed[0], losses_copy=copied[0],
                losses_bit_equal=fed[0] == copied[0],
                tensors=len(state), tensors_bit_equal=same)


def _fed_parity(torch, mx, x_u8, y, planted):
    """One batch-2 f32 step fed through a DeviceFeed on the card against a
    CPU copy with the transform installed, under train_resnet's rules:
    the loss within SERVE_TOL, every running statistic within RUNNING_TOL
    of its scale, and the gradients within the spread rule (the copy's
    own spread: its input nudged by 1 + 2**-22 after the normalize).
    The same step with each of `planted` ({name: wrong transform})
    installed on the card must break at least one of them.  Every card
    step starts from the same running statistics."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import \
        resnet50_v1b
    norm = mx.io.normalize_transform(FED_MEAN, FED_STD, "float32")
    mx.random.seed(0)
    net = resnet50_v1b(classes=1000, device="cuda:0")
    cpu = resnet50_v1b(classes=1000, device="cpu")
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    xf = (torch.from_numpy(x_u8).float() - FED_MEAN) / FED_STD
    _copy_to_cpu(mx, net, cpu, xf[:1])
    start = {k: v.clone() for k, v in net.state_dict().items()}
    yt = torch.from_numpy(y)
    cpu.set_input_transform(norm)
    ref_loss, ref, ref_running = _resnet_grads(
        mx, cpu, loss_fn, torch.from_numpy(x_u8), yt)
    cpu.set_input_transform(None)
    _, spread_grads, _ = _resnet_grads(mx, cpu, loss_fn,
                                       xf * (1.0 + 2.0 ** -22), yt)
    spread = _scaled_err(spread_grads, ref)
    rows = {}
    for name, tr in [("normalize", norm)] + sorted(planted.items()):
        net.load_state_dict(start)
        net.set_input_transform(tr)
        fed_x, fed_y = next(iter(mx.io.DeviceFeed([(x_u8, y)],
                                                  ctx=mx.gpu(0))))
        loss, grads, running = _resnet_grads(mx, net, loss_fn, fed_x._data,
                                             fed_y._data)
        err = _scaled_err(grads, ref)
        run_err = _scaled_err(running, ref_running)
        worst = max(err, key=err.get)
        worst_run = max(run_err, key=run_err.get)
        row = dict(loss_max_abs_err=(loss - ref_loss).abs().max().item(),
                   worst_running_err_over_scale=run_err[worst_run],
                   worst_running=worst_run, running_tensors=len(run_err),
                   grad_err_over_scale_max=dict(
                       card=err[worst], cpu_spread=max(spread.values())),
                   grad_err_over_scale_median=dict(
                       card=statistics.median(err.values()),
                       cpu_spread=statistics.median(spread.values())),
                   worst_grad=worst, gradients=len(err))
        row["within_loss_tol"] = row["loss_max_abs_err"] <= SERVE_TOL
        row["within_running_tol"] = run_err[worst_run] <= RUNNING_TOL
        row["within_spread_rule"] = all(
            v["card"] <= RESNET_SPREAD_FACTOR * v["cpu_spread"]
            for v in (row["grad_err_over_scale_max"],
                      row["grad_err_over_scale_median"]))
        row["passes"] = (row["within_loss_tol"] and row["within_running_tol"]
                         and row["within_spread_rule"])
        rows[name] = row
    return dict(batch=len(y), dtype="float32", loss_tol=SERVE_TOL,
                running_tol=RUNNING_TOL,
                spread_factor=RESNET_SPREAD_FACTOR, **rows)


def _h2d(torch, host):
    """Host-to-card copy rate (GB/s, CUDA events) of one uint8 batch from
    pinned and from pageable memory, and the host copy into a pinned
    buffer that the feed's staging makes (host clock, median of 10)."""
    src = torch.from_numpy(host)
    pinned = src.pin_memory()
    dev = torch.empty(src.shape, dtype=src.dtype, device="cuda:0")
    nbytes = src.numel()
    pinned_ms = _time_ms(torch, lambda: dev.copy_(pinned, non_blocking=True),
                         reps=10, rounds=3)
    pageable_ms = _time_ms(torch, lambda: dev.copy_(src), reps=10, rounds=3)
    view = pinned.numpy()
    staging = []
    for _ in range(10):
        t0 = time.perf_counter()
        view[...] = host
        staging.append((time.perf_counter() - t0) * 1e3)
    staging_ms = statistics.median(staging)
    return dict(bytes=nbytes, pinned_ms=pinned_ms, pageable_ms=pageable_ms,
                pinned_gb_s=nbytes / pinned_ms / 1e6,
                pageable_gb_s=nbytes / pageable_ms / 1e6,
                staging_ms=staging_ms,
                staging_gb_s=nbytes / staging_ms / 1e6)


def phase_train_resnet_fed(torch, mx, cs):
    """resnet50_v1b trained from a JPEG RecordIO file through the port's
    user entry points, as bench.py's run_cachedop feeds it: ImageRecordIter
    with the decode service's workers and ctx=gpu(0) (its DeviceFeed),
    uint8 on the wire, the normalize installed with set_input_transform
    and captured into the hybridized step.  Returns the conv kernel's
    launches by the counters (the eager and the capturing warm-up steps)
    and per replayed step by name."""
    import shutil
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import \
        resnet50_v1b
    from incubator_mxnet_tpu_torch.monitor import events
    batch = RESNET_BATCH
    workers = min(4, os.cpu_count() or 1)
    tmp = tempfile.mkdtemp(prefix="mxt-fed-")
    it = None
    phase_t0 = time.perf_counter()
    try:
        path = os.path.join(tmp, "fed.rec")
        t0 = time.perf_counter()
        codec = _fed_corpus(mx, path)
        corpus_s = time.perf_counter() - t0
        decode, host = _fed_decode_alone(mx, path, batch, workers)
        decode["host_costs"] = _fed_host_costs(path)

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mx.random.seed(0)
        net = resnet50_v1b(classes=1000, device="cuda:0")
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd", {
            "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})
        net.hybridize(static_alloc=True, static_shape=True)
        calls = [0]             # the transform's Python calls
        norm = mx.io.normalize_transform(FED_MEAN, FED_STD, "bfloat16")

        def transform(x):
            calls[0] += 1
            return norm(x)
        net.set_input_transform(transform)
        it = mx.io.ImageRecordIter(
            path, FED_SHAPE, batch, resize=FED_RESIZE, rand_crop=True,
            rand_mirror=True, shuffle=True, dtype="uint8", workers=workers,
            ctx=mx.gpu(0))
        _check(it.io_workers == workers, "ImageRecordIter runs %d decode "
               "workers, not the %d asked for: the decode service did not "
               "start" % (it.io_workers, workers))

        def step(b):
            return _fed_step(mx, net, loss_fn, trainer, b.data[0],
                             b.label[0])
        cs.conv1x1_stats_launches = 0       # the main path starts here
        first = next(it)
        data0 = first.data[0].asnumpy()
        label0 = first.label[0].asnumpy()
        ids = [int(v) for v in label0]
        expected, wid_seq = _fed_expected(path, ids, batch, workers)
        bytes_row = dict(
            wid_seq=wid_seq, dtype=str(data0.dtype), shape=list(data0.shape),
            device=str(first.data[0].context), pad=first.pad,
            labels_equal=ids == [i % 1000 for i in ids]
            and len(set(ids)) == batch,
            bytes_equal=expected is not None
            and np.array_equal(data0, expected),
            bytes_differing=None if expected is None
            else int((data0 != expected).sum()))
        warm = []
        for b in (first, next(it)):
            g0, c0 = _graph_counts((net,), trainer), cs.conv1x1_stats_launches
            step(b)
            g1 = _graph_counts((net,), trainer)
            warm.append(dict(conv=cs.conv1x1_stats_launches - c0,
                             **{k: g1[k] - g0[k] for k in g1}))
        torch.cuda.synchronize()
        warm_calls = calls[0]

        # the timed steps: two epochs from the file
        f0, wait0 = mx.io.feed_counters(), events.get("io.decode.wait_us")
        g0, c0 = _graph_counts((net,), trainer), cs.conv1x1_stats_launches
        ev = [torch.cuda.Event(enable_timing=True)]
        losses = []
        t0 = time.perf_counter()
        ev[0].record()
        for _ in range(FED_EPOCHS):
            it.reset()
            for b in it:
                losses.append(step(b))
                ev.append(torch.cuda.Event(enable_timing=True))
                ev[-1].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = cs.conv1x1_stats_launches    # the main path ends here
        steps = len(losses)
        g1 = _graph_counts((net,), trainer)
        f1 = mx.io.feed_counters()
        timed = dict(steps=steps, images=steps * batch,
                     transform_calls=calls[0] - warm_calls,
                     conv_counter=launches - c0,
                     **{k: g1[k] - g0[k] for k in g1})
        per_batch = {k: (f1.get(k, 0) - f0.get(k, 0)) / steps for k in (
            "feed.read_us", "feed.transfer_us", "feed.stall_us",
            "feed.step_us", "feed.bytes")}
        per_batch["io.decode.wait_us"] = \
            (events.get("io.decode.wait_us") - wait0) / steps
        step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
        fed_rate = steps * batch / wall
        losses = [v.item() for v in losses]

        # the same step on a batch already on the card
        x_dev, y_dev = first.data[0], first.label[0]
        _fed_step(mx, net, loss_fn, trainer, x_dev, y_dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            _fed_step(mx, net, loss_fn, trainer, x_dev, y_dev)
        torch.cuda.synchronize()
        synth_rate = steps * batch / (time.perf_counter() - t0)

        # a fed step's busy share and launches by name
        def fed_next():
            try:
                b = next(it)
            except StopIteration:
                it.reset()
                b = next(it)
            return step(b)
        rows, prof_wall = _device_kernels(torch, fed_next, PROFILE_STEPS)
        device_us = sum(r[0] for r in rows)
        kernels = _port_kernel_calls(rows, PROFILE_STEPS)
        conv_per_step = _profiled_counts(kernels)[3]
        # an epoch from its start, as the timed steps ran it
        it.reset()
        busy = _fed_busy(torch, fed_next, FED_IMAGES // batch)
        it.close()
        it = None
        peak = torch.cuda.max_memory_allocated()

        copy_row = _fed_against_copy(torch, mx, net, loss_fn, trainer,
                                     host[:FED_COPY_STEPS])
        h2d = _h2d(torch, host[0][0])
        del net, trainer
        torch.cuda.empty_cache()
        parity = _fed_parity(
            torch, mx, host[0][0][:RESNET_PARITY_BATCH],
            host[0][1][:RESNET_PARITY_BATCH], _fed_planted(mx))
    finally:
        if it is not None:
            it.close()
        shutil.rmtree(tmp, ignore_errors=True)
    out = dict(phase="train_resnet_fed", model="resnet50_v1b", classes=1000,
               batch=batch, image=list(FED_SHAPE), wire_dtype="uint8",
               compute_dtype="bfloat16", optimizer="sgd", lr=0.1,
               momentum=0.9, wd=1e-4, codec=codec, corpus=dict(
                   images=FED_IMAGES, hw=list(FED_IMAGE_HW),
                   quality=FED_QUALITY, seconds=corpus_s),
               decode_alone=decode, io_workers=workers,
               cpu_count=os.cpu_count(), first_batch=bytes_row,
               warmup_steps=warm, timed=timed, step_ms=step_ms,
               step_ms_median=statistics.median(step_ms), wall_s=wall,
               fed_images_per_s=fed_rate,
               synthetic_images_per_s=synth_rate,
               fraction_of_synthetic=fed_rate / synth_rate,
               decode_alone_over_synthetic=decode["images_per_s"]
               / synth_rate,
               per_batch=per_batch, losses=losses,
               busy_epoch=busy,
               profile=dict(steps=PROFILE_STEPS, wall_us=prof_wall,
                            device_us=device_us,
                            busy_share=device_us / prof_wall,
                            port_kernels=kernels,
                            top=[dict(kernel=k[:80], us=us, calls=n)
                                 for us, k, n in rows[:8]]),
               conv1x1_stats_launches=launches,
               conv_launches_per_replayed_step=conv_per_step,
               max_memory_allocated=peak, feed_against_copy=copy_row,
               h2d=h2d, parity=parity,
               seconds=time.perf_counter() - phase_t0)
    _emit(out)
    _check(bytes_row["bytes_equal"] and bytes_row["labels_equal"]
           and bytes_row["pad"] == 0,
           "the first fed batch differs from the host decode: %r"
           % (bytes_row,))
    _check(copy_row["losses_bit_equal"]
           and copy_row["tensors_bit_equal"] == copy_row["tensors"],
           "the fed steps differ from the copied ones: %r" % (copy_row,))
    _check(parity["normalize"]["passes"],
           "the fed f32 step differs from the CPU copy's (loss within %g, "
           "running statistics within %g of scale, gradients within %g x "
           "the copy's spread): %r" % (SERVE_TOL, RUNNING_TOL,
                                       RESNET_SPREAD_FACTOR,
                                       parity["normalize"]))
    for name in _fed_planted(mx):
        _check(not parity[name]["passes"], "the parity check passed the "
               "planted transform %s: %r" % (name, parity[name]))
    _check([w["conv"] for w in warm] == [RESNET_SITES, RESNET_SITES]
           and [w["captures"] > 0 for w in warm] == [False, True],
           "the warm-up steps (eager, then the capture) did %r" % (warm,))
    _check(timed["captures"] == timed["eager_calls"] ==
           timed["eager_updates"] == timed["transform_calls"] ==
           timed["conv_counter"] == 0 and timed["replays"] > 0,
           "the timed fed steps did not only replay (the normalize inside "
           "the replay): %r" % (timed,))
    _check(steps == FED_EPOCHS * FED_IMAGES // batch,
           "%d timed steps, not %d" % (steps,
                                       FED_EPOCHS * FED_IMAGES // batch))
    _check(conv_per_step == RESNET_SITES, "a replayed fed step launched "
           "the conv kernel %d times by name, not %d"
           % (conv_per_step, RESNET_SITES))
    _check(all(math.isfinite(v) for v in losses),
           "non-finite fed training loss: %r" % (losses,))
    return dict(launches=launches, per_replayed_step=conv_per_step)


def _window(eng, rs, vocab):
    """Sustained traffic: WINDOW_CLIENTS threads each submit
    WINDOW_PER_CLIENT singles, keeping WINDOW_INFLIGHT of them outstanding
    and dropping each result once it is checked.  Returns each request's
    e2e latency (s, submit -> future resolved) and the window's wall."""
    n = WINDOW_CLIENTS * WINDOW_PER_CLIENT
    toks = rs.randint(0, vocab, size=(n, SEQ)).astype(np.int32)
    lat = []
    lock = threading.Lock()

    def stamp(t_sub):
        def done(_fut):
            dt = time.monotonic() - t_sub
            with lock:
                lat.append(dt)
        return done

    def take(fut):
        out = fut.result(timeout=300)
        _check(tuple(out.shape) == (SEQ, vocab),
               "window result shape %s" % (tuple(out.shape),))

    def client(rows):
        pending = deque()
        for row in rows:
            if len(pending) == WINDOW_INFLIGHT:
                take(pending.popleft())
            t_sub = time.monotonic()
            fut = eng.submit(row)
            fut.add_done_callback(stamp(t_sub))
            pending.append(fut)
        while pending:
            take(pending.popleft())

    t0 = time.monotonic()
    with ThreadPoolExecutor(WINDOW_CLIENTS) as pool:
        jobs = [pool.submit(client, toks[j::WINDOW_CLIENTS])
                for j in range(WINDOW_CLIENTS)]
        for job in jobs:
            job.result(timeout=600)     # re-raises a client's failure
    wall = time.monotonic() - t0
    _check(len(lat) == n, "%d of %d window requests resolved"
           % (len(lat), n))
    return np.asarray(lat), wall


def _event_ms(torch, fn, reps=SERVE_TIMED):
    """Median of `reps` single calls of `fn`, each by CUDA events on the
    current stream, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def _serve_buckets(torch, eng, net, rs, vocab, layers):
    """Each bucket's captured program replayed against the same forward
    run eagerly (CUDA events, median), a whole replayed batch through the
    engine's own path (`_run`: stage, replay, copy out, sync) by its host
    wall, and that batch's profile: busy share and the flash forward's
    launches by the profiler's kernel names (`layers` a batch)."""
    rows = {}
    for b in SERVE_BUCKETS:
        x_np = rs.randint(0, vocab, size=(b, SEQ)).astype(np.int32)
        x = torch.from_numpy(x_np).to(SERVE_DEVICE)
        prog = eng._programs[(0, b)]
        with torch.inference_mode():
            eager_ms = _event_ms(torch, lambda: net(x))
        replay_ms = _event_ms(torch, prog.replay)
        kernels, wall_us = _device_kernels(
            torch, lambda: eng._run(0, x_np, []), SERVE_PROFILED)
        device_us = sum(r[0] for r in kernels)
        calls = _port_kernel_calls(kernels, SERVE_PROFILED)
        rows[b] = dict(replayed_ms=replay_ms, eager_ms=eager_ms,
                       eager_over_replayed=eager_ms / replay_ms,
                       batch_wall_ms=wall_us / SERVE_PROFILED / 1e3,
                       device_ms=device_us / SERVE_PROFILED / 1e3,
                       busy_share=device_us / wall_us,
                       port_kernels_per_batch=calls)
        _check(calls == {"flash_fwd_kernel": layers},
               "a replayed bucket-%d batch launched %r of the port's "
               "kernels, not %d flash forwards" % (b, calls, layers))
    return rows


def _serve_swap(torch, mx, eng, net, rs, vocab):
    """`refresh_params_from` a second BERT-base while a client keeps
    submitting: no capture, and what is served after the swap is the
    new weights' output.  The new weights are loaded into the source on
    the default stream behind a stall, with no sync before the swap,
    which must wait for them."""
    from incubator_mxnet_tpu_torch.monitor import events
    mx.random.seed(1)
    v2 = mx.models.bert_base(device=SERVE_DEVICE).eval()
    probe = rs.randint(0, vocab, size=(SEQ,)).astype(np.int32)
    x = torch.from_numpy(probe[None]).to(SERVE_DEVICE)
    with torch.inference_mode():
        ref1, ref2 = net(x)[0], v2(x)[0]
    weights = {k: v.clone() for k, v in v2.state_dict().items()}
    with torch.no_grad():
        for t in v2.state_dict().values():
            t.zero_()
    torch.cuda.synchronize()
    before = eng.submit(probe).result(timeout=300)
    stop, served, errors = threading.Event(), [0], []
    toks = rs.randint(0, vocab, size=(16, SEQ)).astype(np.int32)

    def client():
        try:
            while not stop.is_set():
                for f in [eng.submit(t) for t in toks[:4]]:
                    out = f.result(timeout=300)
                    _check(bool(torch.isfinite(out).all()),
                           "non-finite logits during the swap")
                    served[0] += 1
        except Exception as e:          # noqa: BLE001 — re-raised below
            errors.append(e)

    traces = events.get("serve.traces")
    t = threading.Thread(target=client)
    t.start()
    time.sleep(0.2)
    torch.cuda._sleep(SWAP_STALL_CYCLES)
    v2.load_state_dict(weights)
    t0 = time.perf_counter()
    eng.refresh_params_from(v2, version="v2")
    swap_ms = (time.perf_counter() - t0) * 1e3
    after = eng.submit(probe).result(timeout=300)
    time.sleep(0.2)
    stop.set()
    t.join(timeout=300)
    if errors:
        raise errors[0]
    captures = events.get("serve.traces") - traces
    row = dict(swap_ms=swap_ms, captures=captures,
               served_during=served[0],
               before_vs_v1=(before - ref1).abs().max().item(),
               after_vs_v2=(after - ref2).abs().max().item(),
               after_vs_v1=(after - ref1).abs().max().item())
    _check(captures == 0, "the swap captured %d programs" % captures)
    _check(row["before_vs_v1"] <= SERVE_TOL
           and row["after_vs_v2"] <= SERVE_TOL,
           "served logits differ from the served weights' forward: %r"
           % row)
    _check(row["after_vs_v1"] > 100 * SERVE_TOL,
           "the swap served v1's logits")
    del v2
    return row


def _serve_replicas(torch, mx, net, rs, vocab):
    """Two replicas of one engine on cuda:0, retries off, cooldown
    SERVE_COOLDOWN_S: the serve.infer fault plan fails calls 2 and 4,
    which round-robin puts on replica 1; it is marked unhealthy and the
    traffic that follows routes around it; after the cooldown one probe
    re-admits it."""
    from incubator_mxnet_tpu_torch import config as cfg
    from incubator_mxnet_tpu_torch import fault
    from incubator_mxnet_tpu_torch.monitor import events
    cfg.set("MXNET_RETRY_MAX", 0)
    cfg.set("MXNET_SERVE_REPLICA_FAILS", 2)
    cfg.set("MXNET_SERVE_REPLICA_COOLDOWN_S", SERVE_COOLDOWN_S)
    try:
        eng = mx.serving.InferenceEngine(
            net, devices=[SERVE_DEVICE] * 2, buckets=SERVE_BUCKETS,
            example_shape=(SEQ,), wire_dtype="int32",
            cost_label="serve.infer:bert_base_replicas")
        traces = events.get("serve.traces")
        eng.warmup()
        captures = events.get("serve.traces") - traces
        toks = rs.randint(0, vocab, size=(48, SEQ)).astype(np.int32)
        fault.clear()
        fault.install("serve.infer", at_calls=[2, 4])
        failed = 0
        for t in toks[:4]:                  # sequential: r0 r1 r0 r1
            if eng.submit(t).exception(timeout=300) is not None:
                failed += 1
        health = list(eng.stats()["replica_health"])
        mark = list(eng.stats()["device_batches"])
        futs = [eng.submit(t) for t in toks[4:36]]
        outs = [f.result(timeout=300) for f in futs]
        routed = list(eng.stats()["device_batches"])
        time.sleep(SERVE_COOLDOWN_S + 0.1)
        for t in toks[36:]:
            eng.submit(t).result(timeout=300)
        fault.clear()
        final = eng.stats()
        with torch.inference_mode():
            ref = net(torch.from_numpy(toks[4:8]).to(SERVE_DEVICE))
        err = max((o - r).abs().max().item() for o, r in zip(outs, ref))
        eng.close(timeout=60)
    finally:
        for k in ("MXNET_RETRY_MAX", "MXNET_SERVE_REPLICA_FAILS",
                  "MXNET_SERVE_REPLICA_COOLDOWN_S"):
            cfg.unset(k)
    row = dict(captures=captures, failed=failed,
               health_after_faults=health, batches_at_mark=mark,
               batches_after_traffic=routed,
               health_final=final["replica_health"],
               batches_final=final["device_batches"],
               recovered=events.get("serve.replica_recovered"),
               max_abs_err=err)
    _check(captures == 2 * len(SERVE_BUCKETS), "%d captures for 2 replicas"
           % captures)
    _check(failed == 2 and health == ["healthy", "unhealthy"],
           "the faulted replica was not marked: %r" % row)
    _check(routed[1] == mark[1] and routed[0] > mark[0],
           "traffic reached the unhealthy replica: %r" % row)
    _check(final["replica_health"] == ["healthy", "healthy"]
           and final["device_batches"][1] > mark[1],
           "the replica was not re-admitted after its cooldown: %r" % row)
    _check(err <= SERVE_TOL, "replica outputs differ from the forward by "
           "%g" % err)
    return row


def phase_serve(torch, mx, att):
    from incubator_mxnet_tpu_torch.monitor import events
    from incubator_mxnet_tpu_torch.telemetry import costs
    rs = np.random.RandomState(0)
    mx.random.seed(0)
    torch.cuda.reset_peak_memory_stats()
    net = mx.models.bert_base(device=SERVE_DEVICE)
    vocab = net.decoder.weight.shape[0]
    layers = len(net.encoder.layers)
    eng = net.inference_engine(device=SERVE_DEVICE, buckets=SERVE_BUCKETS,
                               example_shape=(SEQ,), wire_dtype="int32",
                               cost_label="serve.infer:bert_base")
    singles = [rs.randint(0, vocab, size=(SEQ,)).astype(np.int32)
               for _ in range(12)]
    batch = rs.randint(0, vocab, size=(3, SEQ)).astype(np.int32)
    futures = {}
    lock = threading.Lock()

    def client(idx):
        for i in idx:
            fut = eng.submit(singles[i])
            with lock:
                futures[i] = fut

    att.flash_fwd_launches = 0          # the main path starts here
    traces0 = events.get("serve.traces")
    warm = eng.warmup()
    warm_captures = events.get("serve.traces") - traces0
    warm_launches = att.flash_fwd_launches
    # a burst: 12 singles from 3 threads and one batch of 3, every result
    # kept and checked
    threads = [threading.Thread(target=client, args=(range(j, 12, 3),))
               for j in range(3)]
    for t in threads:
        t.start()
    batch_fut = eng.submit_batch(batch)
    for t in threads:
        t.join(timeout=300)
    results = {i: f.result(timeout=300) for i, f in futures.items()}
    batch_out = batch_fut.result(timeout=300)
    before = eng.stats()
    lat, wall = _window(eng, rs, vocab)
    launches = att.flash_fwd_launches   # the main path ends here
    traffic_captures = events.get("serve.traces") - traces0 - warm_captures
    stats = eng.stats()
    batches = stats["batches"]

    _check(warm_captures == len(SERVE_BUCKETS), "warmup made %d captures, "
           "want %d" % (warm_captures, len(SERVE_BUCKETS)))
    _check(traffic_captures == 0, "%d captures in traffic"
           % traffic_captures)
    _check(len(results) == 12, "only %d of 12 singles resolved"
           % len(results))
    for out in results.values():
        _check(tuple(out.shape) == (SEQ, vocab),
               "single result shape %s" % (tuple(out.shape),))
        _check(bool(torch.isfinite(out).all()), "non-finite logits")
    _check(tuple(batch_out.shape) == (3, SEQ, vocab),
           "batch result shape %s" % (tuple(batch_out.shape),))
    _check(bool(torch.isfinite(batch_out).all()), "non-finite logits")
    n_window = WINDOW_CLIENTS * WINDOW_PER_CLIENT
    _check(stats["requests"] == 13 + n_window, "engine counted %d requests"
           % stats["requests"])
    # the wrappers count each capture's launches into its graph; a
    # replayed batch runs no wrapper (its launches are read by name below)
    _check(launches == warm_launches == layers * warm_captures,
           "flash kernel launched %d times (warmup %d) for %d captures of "
           "%d layers" % (launches, warm_launches, warm_captures, layers))

    buckets = _serve_buckets(torch, eng, net, rs, vocab, layers)
    replayed = {b: r["port_kernels_per_batch"].get("flash_fwd_kernel", 0)
                for b, r in buckets.items()}
    # one full bucket forward timed on the card, eager
    x8 = torch.from_numpy(np.stack(singles[:8])).to(SERVE_DEVICE)
    with torch.inference_mode():
        fwd8_ms = _time_ms(torch, lambda: net(x8), reps=3, rounds=3)

    cpu_net = mx.models.bert_base(device="cpu")
    cpu_net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    cpu_net.eval()
    with torch.inference_mode():
        ref = cpu_net(torch.from_numpy(singles[0][None]))[0]
    del cpu_net
    err = (results[0].cpu() - ref).abs().max().item()
    window_buckets = {b: stats["bucket_batches"][b]
                      - before["bucket_batches"][b] for b in SERVE_BUCKETS}
    swap = _serve_swap(torch, mx, eng, net, rs, vocab)
    _check(eng.close(timeout=60), "engine dispatcher did not retire")
    replicas = _serve_replicas(torch, mx, net, rs, vocab)
    _emit(dict(phase="serve", model="bert_base", dtype="float32",
               seq=SEQ, buckets=list(SERVE_BUCKETS),
               warmup_batches=stats["warmup_batches"],
               warmup_captures=warm_captures,
               traffic_captures=traffic_captures,
               burst=dict(requests=13, examples=before["examples"],
                          batches=before["batches"]),
               window=dict(clients=WINDOW_CLIENTS,
                           inflight_per_client=WINDOW_INFLIGHT,
                           requests=n_window,
                           batches=stats["batches"] - before["batches"],
                           bucket_batches=window_buckets, wall_s=wall,
                           requests_per_s=n_window / wall,
                           tokens_per_s=n_window * SEQ / wall,
                           e2e_p50_ms=float(np.percentile(lat, 50) * 1e3),
                           e2e_p99_ms=float(np.percentile(lat, 99) * 1e3),
                           e2e_max_ms=float(lat.max() * 1e3)),
               flash_fwd_launches=launches, batches=batches,
               replayed_batch_flash_launches=replayed,
               per_bucket=buckets,
               warmup_s=warm["wall_s"], forward_bucket8_ms=fwd8_ms,
               swap=swap, replicas=replicas,
               cost_rows=[{k: r[k] for k in (
                   "label", "invocations", "param_bytes", "argument_bytes",
                   "output_bytes", "pool_bytes", "compile_wall_s")}
                   for r in costs.table()
                   if r["label"].startswith("serve.infer:bert_base[")],
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               cpu_max_abs_err=err, cpu_tol=SERVE_TOL))
    _check(err <= SERVE_TOL, "served logits differ from the CPU copy by "
                             "%g > %g" % (err, SERVE_TOL))
    phase_profile(torch, net, x8)
    return launches, replayed


def _reg_window(reg, rs, vocab, seconds):
    """BERT singles through the registry for `seconds`: WINDOW_CLIENTS
    closed-loop clients with WINDOW_INFLIGHT outstanding each, lanes hi
    and lo and tenants t0 and t1 alternating.  Returns (served, shed,
    wall)."""
    from incubator_mxnet_tpu_torch.serving import (DeadlineExceeded,
                                                   QueueFull, Shed)
    toks = rs.randint(0, vocab, size=(64, SEQ)).astype(np.int32)
    stop = time.monotonic() + seconds
    counts = collections.Counter()
    lock = threading.Lock()

    def take(fut):
        try:
            out = fut.result(timeout=300)
            _check(tuple(out.shape) == (SEQ, vocab), "registry result "
                   "shape %s" % (tuple(out.shape),))
            key = "served"
        except (Shed, QueueFull, DeadlineExceeded):
            key = "shed"
        with lock:
            counts[key] += 1

    def client(j):
        pending, i = deque(), 0
        while time.monotonic() < stop:
            if len(pending) == WINDOW_INFLIGHT:
                take(pending.popleft())
            try:
                pending.append(reg.submit(
                    "bert", toks[(i * WINDOW_CLIENTS + j) % len(toks)],
                    lane=REG_LANES[i % 2], tenant="t%d" % (j % 2)))
            except (Shed, QueueFull, DeadlineExceeded):
                with lock:
                    counts["shed"] += 1
            i += 1
        while pending:
            take(pending.popleft())

    t0 = time.monotonic()
    with ThreadPoolExecutor(WINDOW_CLIENTS) as pool:
        for job in [pool.submit(client, j) for j in range(WINDOW_CLIENTS)]:
            job.result(timeout=600)
    return counts["served"], counts["shed"], time.monotonic() - t0


def _reg_generate(reg, prompts, rate, seconds, rs):
    """Poisson generation requests through the registry at `rate` req/s
    for `seconds`, lanes hi (GEN_HI_FRAC) and lo, budgets uniform in
    [3, GEN_MAX_NEW].  Returns (offered, served, shed)."""
    from incubator_mxnet_tpu_torch.serving import (DeadlineExceeded,
                                                   QueueFull, Shed)
    pending, shed, offered = [], 0, 0
    t0 = time.perf_counter()
    next_t = t0
    while time.perf_counter() < t0 + seconds:
        now = time.perf_counter()
        if now < next_t:
            time.sleep(min(next_t - now, 0.002))
            continue
        next_t += rs.exponential(1.0 / rate)
        lane = GEN_LANES[0] if rs.rand() < GEN_HI_FRAC else GEN_LANES[1]
        offered += 1
        try:
            pending.append(reg.generate(
                "nmt", prompts[offered % len(prompts)],
                max_new_tokens=int(rs.randint(3, GEN_MAX_NEW + 1)),
                lane=lane))
        except (Shed, QueueFull, DeadlineExceeded):
            shed += 1
    served = 0
    for st in pending:
        try:
            st.result(timeout=GEN_RESULT_TIMEOUT)
            served += 1
        except (Shed, QueueFull, DeadlineExceeded):
            shed += 1
    return offered, served, shed


def _pcts(events, name, label=None):
    """p50/p99 ms of a series (the unlabeled ring, or its lane's)."""
    if label is None:
        p = events.percentiles(name, (50, 99))
    else:
        p = next((r for r in events.labeled_percentiles(name, (50, 99))
                  if r["labels"] == {"lane": label}), {})
    return {k: p[k] / 1e3 for k in ("p50", "p99") if k in p}


def phase_serve_registry(torch, mx, att):
    """BERT-base and the NMT generator behind one ModelRegistry on
    cuda:0: admission against the card's budget, the ledger against the
    allocator, a denial that allocates nothing, a degraded canary rolled
    back by the default serving SLO rule, a circuit breaker's open-close
    cycle, bit-equal and token-equal parity, and 5 s of mixed traffic.
    Returns the flash forward's launches (each BERT capture's)."""
    from incubator_mxnet_tpu_torch import config as cfg
    from incubator_mxnet_tpu_torch import fault
    from incubator_mxnet_tpu_torch.monitor import events
    from incubator_mxnet_tpu_torch.serving import (
        AdmissionDenied, CircuitOpen, InferenceEngine, ModelRegistry,
        project_footprint)
    from incubator_mxnet_tpu_torch.telemetry import costs, memwatch, slo
    knobs = {"MXNET_SERVE_BREAKER_FAILS": 2,
             "MXNET_SERVE_BREAKER_COOLDOWN_S": REG_BREAKER_COOLDOWN_S,
             "MXNET_CTL_DEGRADE_S": REG_DEGRADE_S, "MXNET_RETRY_MAX": 0}
    for k, v in knobs.items():
        cfg.set(k, v)
    torch.cuda.empty_cache()
    alloc0 = torch.cuda.memory_allocated()
    rs = np.random.RandomState(0)
    mx.random.seed(0)
    bert = mx.models.bert_base(device=SERVE_DEVICE).eval()
    vocab = bert.decoder.weight.shape[0]
    layers = len(bert.encoder.layers)
    mx.random.seed(0)
    nmt = _nmt_model(mx, SERVE_DEVICE)
    row = dict(phase="serve_registry", model="bert_base + "
               "transformer_nmt_base", seq=SEQ, buckets=list(SERVE_BUCKETS),
               gen=dict(slots=GEN_SLOTS, max_len=GEN_MAX_LEN,
                        prompt_buckets=list(GEN_BUCKETS)))
    # the eager reference the rollback is held to, before the path runs
    probe = rs.randint(0, vocab, size=(SEQ,)).astype(np.int32)
    with torch.inference_mode():
        v1_out = bert(torch.from_numpy(probe[None]).to(SERVE_DEVICE))[0]
    try:
        att.flash_fwd_launches = 0      # the main path starts here
        bert_traces = 0                 # captures of BERT programs
        reg = ModelRegistry(devices=[SERVE_DEVICE])
        budget = reg._budgets[0]
        rec_b = reg.register("bert", bert, example_shape=(SEQ,),
                             wire_dtype="int32", buckets=SERVE_BUCKETS,
                             lanes=REG_LANES, lane_quotas=REG_QUOTAS)
        rec_g = reg.register_generator(
            "nmt", nmt, NMT_BOS, GEN_EOS, slots=GEN_SLOTS,
            max_len=GEN_MAX_LEN, prompt_buckets=GEN_BUCKETS,
            lanes=GEN_LANES, lane_quotas=GEN_QUOTAS,
            queue_cap=GEN_QUEUE_CAP)
        traces = events.get("serve.traces")
        reg.warmup()
        captures = events.get("serve.traces") - traces
        bert_traces += len(SERVE_BUCKETS)
        _check(captures == len(SERVE_BUCKETS) + len(GEN_BUCKETS) + 2,
               "registry warmup made %d captures" % captures)
        row["admitted"] = dict(budget=budget, bert=rec_b, nmt=rec_g,
                               warmup_captures=captures)

        # the ledger against the allocator
        torch.cuda.synchronize()
        smp = memwatch.sample(tag="registry", force=True)
        dev_key = memwatch.device_key(SERVE_DEVICE)
        stats = reg.stats()
        held = {}
        for name in ("bert", "nmt"):
            seen = {t.untyped_storage().data_ptr(): t.untyped_storage()
                    .nbytes() for t in reg.engine(name).held_tensors()}
            held[name] = sum(seen.values())
        pools = {name: sum(r["pool_bytes"] or 0 for r in costs.table()
                           if r["label"].startswith(
                               "serve.infer:%s[" % name))
                 for name in ("bert", "nmt:gen")}
        pools["nmt"] = pools.pop("nmt:gen")
        row["ledger"] = dict(
            models={n: dict(projected=rec["footprint_bytes"],
                            committed=m["footprint_bytes"],
                            basis=m["basis"], held_tensor_bytes=held[n],
                            pool_bytes=pools[n],
                            held_plus_pool=held[n] + pools[n])
                    for (n, m), rec in zip(sorted(stats["models"].items()),
                                           (rec_b, rec_g))},
            committed=stats["ledger"][0]["committed"],
            memwatch_used=smp["devices"][dev_key]["used_bytes"],
            memwatch_source=smp["devices"][dev_key]["source"],
            attribution=[{k: r.get(k) for k in (
                "tenant", "committed_bytes", "measured_bytes", "drift")}
                for r in memwatch.attribution(smp)],
            memory_allocated=torch.cuda.memory_allocated(),
            memory_reserved=torch.cuda.memory_reserved(),
            outside_models=torch.cuda.memory_allocated()
            - stats["ledger"][0]["committed"])
        _check(all(m["basis"] == "measured"
                   for m in stats["models"].values()),
               "a model's ledger row was not reconciled: %r"
               % stats["models"])
        _check(row["ledger"]["memwatch_source"] == "memory_stats",
               "memwatch did not read the card's allocator: %r"
               % row["ledger"]["memwatch_source"])

        # a third registration denied under committed + half its
        # projection, before anything is allocated for it
        proj, _ = project_footprint(bert, SERVE_BUCKETS, (SEQ,), "int32")
        committed = reg._committed[0]
        reg._budgets[0] = committed + proj // 2
        torch.cuda.synchronize()
        alloc = torch.cuda.memory_allocated()
        try:
            reg.register("bert_b", bert, example_shape=(SEQ,),
                         wire_dtype="int32", buckets=SERVE_BUCKETS)
            denied = None
        except AdmissionDenied as e:
            denied = str(e)
        torch.cuda.synchronize()
        row["denial"] = dict(budget=reg._budgets[0], committed=committed,
                             projected=proj, message=denied,
                             allocated_before=alloc,
                             allocated_after=torch.cuda.memory_allocated())
        reg._budgets[0] = budget
        _check(denied is not None and "'bert_b'" in denied,
               "the third registration was admitted")
        _check(row["denial"]["allocated_after"] == alloc,
               "the denied registration allocated %d bytes"
               % (row["denial"]["allocated_after"] - alloc))

        # parity: the registry's BERT against a standalone engine over
        # the same weights, bit for bit at buckets 8 and 1
        solo = InferenceEngine(bert, device=SERVE_DEVICE,
                               buckets=SERVE_BUCKETS, example_shape=(SEQ,),
                               wire_dtype="int32")
        solo.warmup()
        bert_traces += len(SERVE_BUCKETS)
        x8 = rs.randint(0, vocab, size=(8, SEQ)).astype(np.int32)
        same = []
        for x in (x8, x8[:1]):
            a = reg.submit_batch("bert", x, lane="hi").result(timeout=300)
            b = solo.submit_batch(x).result(timeout=300)
            same.append(bool(torch.equal(a, b)))
        solo.close(timeout=60)
        del solo
        gen_rows = []
        prompts = [rs.randint(3, NMT_VOCAB, (n,)).astype(np.int32)
                   for n in GEN_PARITY_LENGTHS[:4]]
        streams = [reg.generate("nmt", p, max_new_tokens=m)
                   for p, m in zip(prompts, GEN_PARITY_NEW[:4])]
        with torch.no_grad():
            for p, m, st in zip(prompts, GEN_PARITY_NEW[:4], streams):
                g = st.result(timeout=GEN_RESULT_TIMEOUT)
                ref, _, gaps = _greedy(torch, nmt, p, m, SERVE_DEVICE)
                gen_rows.append(dict(prompt_len=int(p.size), tokens=len(g),
                                     **_near_tie_compare(g, ref, gaps,
                                                         SERVE_TOL)))
        row["parity"] = dict(bert_bit_equal=same, generate=gen_rows)
        _check(all(same), "registry BERT outputs differ from the "
               "standalone engine's: %r" % same)

        # a degraded canary caught by the default serving rules
        mx.random.seed(1)
        v2 = mx.models.bert_base(device=SERVE_DEVICE).eval()
        fault.clear()
        fault.install("model.bad_version", at_calls=[1])
        can = reg.register_version("bert", v2, "v2", fraction=0.25)
        bert_traces += len(SERVE_BUCKETS)   # the canary's warmup
        fault.clear()
        slo.clear_rules()
        rolled = []
        slo.register_action(
            lambda rule, firing, info: firing and rule.startswith("serve-")
            and rolled.append((rule, reg.rollback_version(
                "bert", reason=rule))))
        served, late = _reg_canary_traffic(reg, rs, vocab)
        rules = reg.install_slo_rules()
        fired = slo.evaluate()
        route_after = reg.canary("bert")
        after = reg.submit("bert", probe, lane="hi").result(timeout=300)
        row["canary"] = dict(
            version=can["version"], fraction=can["fraction"],
            tainted=can["tainted"], degrade_s=REG_DEGRADE_S,
            hi_deadline_s=REG_HI_DEADLINE, requests=served, late=late,
            rules=rules, fired=fired,
            rolled_back=[(r, d["version"] if d else None)
                         for r, d in rolled],
            canary_after=route_after, models=sorted(reg.stats()["models"]),
            v1_after_max_abs_err=(after - v1_out).abs().max().item())
        slo.clear_rules()
        del v2
        _check(can["tainted"], "the bad_version fault did not taint v2")
        _check(rolled and rolled[0][1] is not None
               and route_after is None and "bert@v2" not in
               row["canary"]["models"],
               "the SLO rule did not roll the canary back: %r"
               % row["canary"])
        _check(row["canary"]["v1_after_max_abs_err"] <= SERVE_TOL,
               "after the rollback the registry does not serve v1")

        # the circuit breaker: two terminal failures open it, its
        # cooldown lets one probe through, which closes it
        fault.install("serve.infer", at_calls=[1], times=2)
        states = []
        for _ in range(2):
            exc = reg.submit("bert", probe, lane="hi").exception(timeout=300)
            states.append(("fail", type(exc).__name__,
                           reg.stats()["models"]["bert"]["breaker"]))
        fault.clear()
        try:
            reg.submit("bert", probe, lane="hi")
            states.append(("submit", "admitted", "?"))
        except CircuitOpen:
            states.append(("submit", "CircuitOpen",
                           reg.stats()["models"]["bert"]["breaker"]))
        time.sleep(REG_BREAKER_COOLDOWN_S + 0.1)
        reg.submit("bert", probe, lane="hi").result(timeout=300)
        states.append(("probe", "ok",
                       reg.stats()["models"]["bert"]["breaker"]))
        row["breaker"] = dict(cooldown_s=REG_BREAKER_COOLDOWN_S,
                              transitions=states)
        _check([s[2] for s in states] == ["closed", "open", "open",
                                          "closed"],
               "breaker transitions %r" % states)

        # mixed traffic: BERT closed loop beside Poisson generation at
        # half the generator's closed-loop capacity, measured here alone
        gen_prompts = [rs.randint(3, NMT_VOCAB, (n,)).astype(np.int32)
                       for n in rs.randint(5, max(GEN_BUCKETS) + 1, 64)]
        cap = _gen_capacity(reg.engine("nmt"), gen_prompts, GEN_CAPACITY_S,
                            GEN_MAX_NEW)
        events.reset()
        box = {}
        bert_thread = threading.Thread(target=lambda: box.update(
            bert=_reg_window(reg, rs, vocab, REG_MIXED_S)))
        t0 = time.perf_counter()
        bert_thread.start()
        offered, gserved, gshed = _reg_generate(
            reg, gen_prompts, 0.5 * cap, REG_MIXED_S,
            np.random.RandomState(17))
        bert_thread.join(timeout=600)
        wall = time.perf_counter() - t0
        bserved, bshed, bwall = box["bert"]
        mixed_captures = events.get("serve.traces")
        row["mixed"] = dict(
            seconds=REG_MIXED_S, wall_s=wall,
            gen_capacity_rps=cap, gen_rate_rps=0.5 * cap,
            bert=dict(served=bserved, shed=bshed,
                      requests_per_s=bserved / bwall,
                      tokens_per_s=bserved * SEQ / bwall,
                      **{ln: _pcts(events, "serve.e2e_us", ln)
                         for ln in REG_LANES}),
            gen=dict(offered=offered, served=gserved, shed=gshed,
                     tokens=events.get("gen.tokens"),
                     tokens_per_s=events.get("gen.tokens") / wall,
                     ttft=_pcts(events, "gen.ttft_us"),
                     intertoken=_pcts(events, "gen.intertoken_us"),
                     **{ln: _pcts(events, "gen.e2e_us", ln)
                        for ln in GEN_LANES}),
            sheds=dict(serve=events.get("serve.shed"),
                       gen=events.get("gen.shed")),
            captures=mixed_captures)
        _check(mixed_captures == 0, "%d captures in mixed traffic"
               % mixed_captures)
        _check(bserved > 0 and gserved > 0, "mixed traffic served "
               "nothing: %r" % row["mixed"])
        launches = att.flash_fwd_launches   # the main path ends here
        row["flash_fwd_launches"] = launches
        row["bert_captures"] = bert_traces
        reg.close(timeout=120)
        row["memory_allocated_before"] = alloc0
        row["memory_allocated_after_close"] = torch.cuda.memory_allocated()
    finally:
        fault.clear()
        slo.clear_rules()
        for k in knobs:
            cfg.unset(k)
    _emit(row)
    # the wrappers count each BERT capture's launches, one a layer (the
    # registry's, the standalone engine's and the canary's buckets);
    # replays, and the generator, launch none through a wrapper
    _check(launches == layers * bert_traces,
           "flash kernel launched %d times for %d BERT captures of %d "
           "layers" % (launches, bert_traces, layers))
    return launches


# the threads the serving engines start: none may outlive its phase
_SERVING_THREADS = ("ServeDispatcher", "ServeReplica", "ServeBuild",
                    "GenDecodeLoop")


def _serving_retired(torch):
    """After the serving phases: no engine thread is left to put work on
    the card beside the phases that follow, and what the engines held is
    freed (the allocator's bytes are printed)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    threads = sorted(t.name for t in threading.enumerate())
    _emit(dict(phase="serving_retired", threads=threads,
               memory_allocated=torch.cuda.memory_allocated(),
               memory_reserved=torch.cuda.memory_reserved()))
    left = [t for t in threads if t.startswith(_SERVING_THREADS)]
    _check(not left, "serving threads outlived their phase: %r" % left)


def _reg_canary_traffic(reg, rs, vocab):
    """REG_CANARY_REQUESTS singles on lane hi with deadline
    REG_HI_DEADLINE from WINDOW_CLIENTS closed-loop clients; a quarter
    mirror to the degraded canary.  Returns (resolved, past deadline or
    shed)."""
    from incubator_mxnet_tpu_torch.serving import DeadlineExceeded, Shed
    toks = rs.randint(0, vocab, size=(REG_CANARY_REQUESTS, SEQ)) \
        .astype(np.int32)
    counts = collections.Counter()
    lock = threading.Lock()

    def client(rows):
        for x in rows:
            t0 = time.monotonic()
            try:
                reg.submit("bert", x, lane="hi",
                           deadline=REG_HI_DEADLINE).result(timeout=300)
                late = time.monotonic() - t0 > REG_HI_DEADLINE
            except (DeadlineExceeded, Shed):
                late = True
            with lock:
                counts["resolved"] += 1
                counts["late"] += late

    with ThreadPoolExecutor(WINDOW_CLIENTS) as pool:
        for job in [pool.submit(client, toks[j::WINDOW_CLIENTS])
                    for j in range(WINDOW_CLIENTS)]:
            job.result(timeout=600)
    return counts["resolved"], counts["late"]


def _nmt_data():
    """bench.py's run_transformer_nmt inputs: src, tgt and labels (64 x 64
    each) drawn in that order from RandomState(0)."""
    rs = np.random.RandomState(0)
    shape = (NMT_BATCH, NMT_SEQ)
    src = rs.randint(0, NMT_VOCAB, shape).astype(np.int32)
    tgt = rs.randint(0, NMT_VOCAB, shape).astype(np.int32)
    labels = rs.randint(0, NMT_VOCAB, shape).astype(np.float32)
    return src, tgt, labels


def _nmt_model(mx, device, **kw):
    return mx.models.transformer_nmt_base(NMT_VOCAB, NMT_VOCAB, dropout=0.0,
                                          device=device, **kw)


def phase_train_nmt(torch, mx, att):
    """transformer_nmt_base training through the port's entry points, as
    bench.py's run_transformer_nmt; returns each kernel's launches over
    the timed steps, and the causal ones among them."""
    src, tgt, labels = _nmt_data()
    mx.random.seed(0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = _nmt_model(mx, "cuda:0", output_hidden=True)
    head = mx.models.FusedMLMCELoss(NMT_VOCAB, NMT_UNITS, device="cuda:0")
    params = dict(net.collect_params())
    params.update({"loss." + n: p for n, p in head.collect_params().items()})
    trainer = mx.gluon.Trainer(params, "adam", {"learning_rate": 1e-4})

    # parity: one batch-1 step's loss and gradients against a CPU copy
    cpu_net = _nmt_model(mx, "cpu", output_hidden=True)
    cpu_net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    cpu_head = mx.models.FusedMLMCELoss(NMT_VOCAB, NMT_UNITS, device="cpu")
    cpu_head.load_state_dict({k: v.cpu()
                              for k, v in head.state_dict().items()})
    s1, t1, y1 = (torch.from_numpy(a[:1]) for a in (src, tgt, labels))
    with mx.autograd.record():
        ref_loss = cpu_head(cpu_net(s1, t1), y1)
    mx.autograd.backward(ref_loss)
    ref_grads = {n: p.grad for n, p in cpu_net.collect_params().items()}
    ref_grads.update({"loss." + n: p.grad
                      for n, p in cpu_head.collect_params().items()})
    loss1 = _train_step(mx, net, head, trainer, (s1.cuda(), t1.cuda()),
                        y1.cuda())
    loss_err = (loss1.cpu() - ref_loss.detach()).abs().max().item()
    grad_err = _scaled_err({n: p.grad for n, p in params.items()}, ref_grads)
    worst_name = max(grad_err, key=grad_err.get)
    del cpu_net, cpu_head, ref_grads, ref_loss

    s, t, y = (torch.from_numpy(a).cuda() for a in (src, tgt, labels))
    for _ in range(TRAIN_WARMUP):
        _train_step(mx, net, head, trainer, (s, t), y)
    torch.cuda.synchronize()
    _reset_counts(att)                  # the main path starts here
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(TRAIN_STEPS + 1)]
    losses, per_step = [], []
    t0 = time.perf_counter()
    events[0].record()
    for i in range(TRAIN_STEPS):
        before = _all_counts(att)
        losses.append(_train_step(mx, net, head, trainer, (s, t), y).mean())
        events[i + 1].record()
        per_step.append(tuple(a - b for a, b in
                              zip(_all_counts(att), before)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(zip(_COUNT_KEYS, _all_counts(att)))  # the path ends here
    step_ms = [events[i].elapsed_time(events[i + 1])
               for i in range(TRAIN_STEPS)]
    losses = [v.item() for v in losses]
    per_step_want = (2 * NMT_LAYERS,) * 3 + (NMT_LAYERS,) * 3
    _emit(dict(phase="train_nmt", model="transformer_nmt_base",
               dtype="float32", batch=NMT_BATCH, src_len=NMT_SEQ,
               tgt_len=NMT_SEQ, vocab=NMT_VOCAB, optimizer="adam", lr=1e-4,
               parameters=sum(p.numel() for p in params.values()),
               parity=dict(batch=1, loss_max_abs_err=loss_err,
                           loss_mean=loss1.mean().item(),
                           worst_grad_err_over_scale=grad_err[worst_name],
                           worst_grad=worst_name, tol=TRAIN_TOL,
                           tensors=len(grad_err)),
               warmup_steps=TRAIN_WARMUP, steps=TRAIN_STEPS,
               step_ms=step_ms, step_ms_median=statistics.median(step_ms),
               wall_s=wall,
               tgt_tokens_per_s=TRAIN_STEPS * NMT_BATCH * NMT_SEQ / wall,
               losses=losses,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               launches=launches,
               launches_per_step=[dict(zip(_COUNT_KEYS, c))
                                  for c in sorted(set(per_step))]))
    _check(loss_err <= SERVE_TOL, "batch-1 loss differs from the CPU copy "
           "by %g > %g" % (loss_err, SERVE_TOL))
    _check(grad_err[worst_name] <= TRAIN_TOL, "gradient of %s differs from "
           "the CPU copy: %g of its scale > %g"
           % (worst_name, grad_err[worst_name], TRAIN_TOL))
    _check(all(math.isfinite(v) for v in losses),
           "non-finite training loss: %r" % (losses,))
    _check(all(c == per_step_want for c in per_step),
           "a training step launched %r (%s), not %r"
           % (per_step, ", ".join(_COUNT_KEYS), per_step_want))
    _profile(torch, lambda: _train_step(mx, net, head, trainer, (s, t), y), 1,
             top=16, phase="train_nmt_profile",
             batch=[NMT_BATCH, NMT_SEQ, NMT_SEQ], steps=1)
    return launches


def _mlm_build(mx, net_fn, vocab, units, dtype=None, optimizer="adam",
               optimizer_params=None, no_wd=None):
    """(net, FusedMLMCELoss, Trainer) fresh from seed 0, cast to `dtype`
    where given, as the training phases build them: Adam lr 1e-4 unless
    `optimizer` and `optimizer_params` say otherwise, with wd_mult 0 on
    the parameters whose structural names match `no_wd`."""
    def build():
        mx.random.seed(0)
        net, head = net_fn(), mx.models.FusedMLMCELoss(vocab, units,
                                                       device="cuda:0")
        if dtype is not None:
            net.cast(dtype)
            head.cast(dtype)
        if no_wd is not None:
            for blk in (net, head):
                blk.collect_params(no_wd).setattr("wd_mult", 0.0)
        params = dict(net.collect_params())
        params.update({"loss." + n: p
                       for n, p in head.collect_params().items()})
        return net, head, mx.gluon.Trainer(
            params, optimizer, dict(optimizer_params
                                    or {"learning_rate": 1e-4}))
    return build


def _bf16_mlm_batch(torch):
    """The bf16 BERT phases' batch: BF16_BATCH x SEQ tokens and labels
    from RandomState(0), on the card."""
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, 30522, (BF16_BATCH, SEQ)).astype(np.int32)
    labels = rs.randint(0, 30522, (BF16_BATCH, SEQ)).astype(np.float32)
    return torch.from_numpy(tokens).cuda(), torch.from_numpy(labels).cuda()


def _flash_per_step(causal):
    """A step's launches of (fwd, dq, dkv, their causal ones, conv, nms)
    on a path through 12 attention layers."""
    return (12,) * 3 + (causal,) * 3 + (0, 0)


def phase_hybridize_all(torch, mx, att, cs):
    """train_bf16, train_nmt and train_resnet_gluon, each eager and
    hybridized as bench.py hybridizes them (`phase_hybridize`), with the
    host trace of one eager bf16 and NMT step; returns the hybridized
    runs by path."""
    x, y = _bf16_mlm_batch(torch)
    out = {}
    flash = _flash_per_step
    out["train_bf16"] = phase_hybridize(
        torch, mx, att, cs, "train_bf16",
        _mlm_build(mx, lambda: mx.models.bert_base(
            dropout=0.0, output_hidden=True, device="cuda:0"), 30522, 768,
            "bfloat16"),
        lambda n, h, t: _train_step(mx, n, h, t, (x,), y).mean(),
        BF16_BATCH * SEQ, flash(0), trace=True)
    src, tgt, lab = (torch.from_numpy(a).cuda() for a in _nmt_data())
    out["train_nmt"] = phase_hybridize(
        torch, mx, att, cs, "train_nmt",
        _mlm_build(mx, lambda: _nmt_model(mx, "cuda:0", output_hidden=True),
                   NMT_VOCAB, NMT_UNITS),
        lambda n, h, t: _train_step(mx, n, h, t, (src, tgt), lab).mean(),
        NMT_BATCH * NMT_SEQ, flash(NMT_LAYERS), trace=True)
    img, ilab = _resnet_batch(torch)
    out["train_resnet_gluon"] = phase_hybridize(
        torch, mx, att, cs, "train_resnet_gluon", _gluon_build(mx),
        lambda n, h, t: _gluon_step(mx, n, t, h, img, ilab)[1],
        RESNET_BATCH, (0,) * 6 + (RESNET_SITES, 0))
    return out


# -- slice 17: LAMB at BERT-base width, and the optimizers on a user block ---

LAMB_PARAMS = {"learning_rate": 1e-4, "wd": 0.01, "epsilon": 1e-6}
# GluonNLP's run_pretraining.py: no weight decay on LayerNorm and biases
LAMB_NO_WD = ".*(gamma|beta|bias)$"
# the card's LAMB update of bf16 weights against the port's CPU update of
# bf16 copies of the same values, which rounds as the card does (f32
# arithmetic, g' and the norms rounded to bf16, one rounding into each
# weight): the two differ only where the devices' f32 sums (the norms) or
# contracted products round otherwise.  Each element within one bf16 ulp
# of itself plus LAMB_STEP_RTOL of the CPU's step (g', r1, r2 and their
# ratio each rounded to bf16, each within 2**-7 of itself where it rounds
# otherwise), and of the elements that either side moves at most
# LAMB_STEP_MISMATCH with another step: a norm one bf16 ulp off scales its
# tensor's steps by 2**-8 and flips the rounding of about that share of
# its moved elements.  A no-op update, lr x 2 and a sign flip, planted
# through the same check, mismatch most moved elements and must fail
LAMB_STEP_RTOL = 2.0 ** -5
LAMB_STEP_MISMATCH = 0.01
# replays of a captured update timed by CUDA events (median), and profiled:
# a window of 10 LAMB updates (94k kernel records) lost records on the card
UPDATE_REPS = 10
UPDATE_PROFILED = 2


def _update_program_ms(torch, trainer):
    """One replay of `trainer`'s captured update: its ms by CUDA events
    (median of UPDATE_REPS), its kernels' device ms and launches by
    torch.profiler over UPDATE_PROFILED replays, the costliest kernels
    (the replays move the weights on: call it last)."""
    program = trainer._program[1]
    events_ms = _event_ms(torch, program.replay, reps=UPDATE_REPS)
    ms, kernels = _device_ms(torch, program.replay, reps=UPDATE_PROFILED)
    return dict(ms=events_ms, device_ms=ms,
                launches=sum(k["calls"] for k in kernels), top=kernels[:4])


def _lamb_step_counts(torch, old, new, ref):
    """One weight's update `new` from `old` against the reference update
    `ref`: (the largest element difference over its allowance, one bf16
    ulp of the larger of the two values plus LAMB_STEP_RTOL of the
    reference's step; elements moved by either; elements that differ;
    elements)."""
    o, n, r = old.float(), new.float(), ref.float()
    _, e = torch.frexp(torch.maximum(n.abs(), r.abs()))
    allow = torch.exp2((e - 8).float()) + LAMB_STEP_RTOL * (r - o).abs()
    return ((n - r).abs().div_(allow).max().item(),
            int(((n != o) | (r != o)).sum()), int((n != r).sum()), o.numel())


def _lamb_step_check(rows):
    """Merges `_lamb_step_counts` rows: the largest element difference
    over its allowance, the share of elements that the updates move, the
    share of moved elements whose steps differ, and whether these pass
    (something moved, each element within its allowance, the mismatch
    within LAMB_STEP_MISMATCH)."""
    err = max(r[0] for r in rows)
    moved, differ, total = (sum(r[i] for r in rows) for i in (1, 2, 3))
    mismatch = differ / max(moved, 1)
    return dict(max_elem_err=err, moved_share=moved / total,
                step_mismatch=mismatch,
                ok=bool(moved > 0 and err <= 1.0
                        and mismatch <= LAMB_STEP_MISMATCH))


def _lamb_updates(mx, params, olds, grads, lr):
    """LAMB_PARAMS's update at `lr` of copies of `olds` from `grads`,
    each weight its own index of one optimizer over `params` (their
    wd_mult): the new weights."""
    opt = mx.optimizer.create("lamb", param_dict=dict(enumerate(params)),
                              **dict(LAMB_PARAMS, learning_rate=lr))
    news = []
    for i, (w, g) in enumerate(zip(olds, grads)):
        w = w.clone()
        opt.update(i, w, g, opt.create_state(i, w))
        news.append(w)
    return news


def _lamb_parity(torch, mx, params, names):
    """One LAMB update of each bf16 card weight from fixed gradients
    (N(0, 1e-3) from a seeded card generator, bf16), held against the
    port's update of bf16 CPU copies of the same values
    (`_lamb_step_check`), per weight and over all; and the planted
    controls, each held the same way: the weights left as they were,
    the card's update at twice the lr, and its step negated."""
    gen = torch.Generator(device="cuda:0")
    gen.manual_seed(1)
    olds = [p.detach().clone() for p in params]
    grads = [(torch.randn(p.shape, generator=gen, device=p.device)
              * 1e-3).to(p.dtype) for p in params]
    lr = LAMB_PARAMS["learning_rate"]
    card = _lamb_updates(mx, params, olds, grads, lr)
    twice = _lamb_updates(mx, params, olds, grads, 2 * lr)
    olds = [w.cpu() for w in olds]
    ref = _lamb_updates(mx, params, olds, [g.cpu() for g in grads], lr)
    card, twice = [w.cpu() for w in card], [w.cpu() for w in twice]
    flip = [2 * o.float() - n.float() for o, n in zip(olds, card)]
    rows = {k: [_lamb_step_counts(torch, o, n, r)
                for o, n, r in zip(olds, news, ref)]
            for k, news in (("card", card), ("noop", olds),
                            ("lr_x2", twice), ("sign_flip", flip))}
    per_weight = {name: _lamb_step_check([row])
                  for name, row in zip(names, rows["card"])}
    worst = sorted(per_weight.items(),
                   key=lambda kv: -kv[1]["step_mismatch"])[:5]
    return dict(_lamb_step_check(rows["card"]), weights=len(params),
                step_rtol=LAMB_STEP_RTOL,
                step_mismatch_tol=LAMB_STEP_MISMATCH,
                worst=[dict(name=k, **v) for k, v in worst],
                controls={k: _lamb_step_check(rows[k])
                          for k in ("noop", "lr_x2", "sign_flip")})


def phase_train_lamb(torch, mx, att, cs):
    """BERT-base MLM in bf16 (bert_base + FusedMLMCELoss cast to bf16,
    batch 16 x 512, the bf16 phases' data) trained with LAMB (lr 1e-4, wd
    0.01, epsilon 1e-6, no wd on LayerNorm gamma/beta and biases), eager
    and hybridized (`phase_hybridize`: 12 launches of each flash kernel a
    step, timed steps only replaying); both modes' losses and parameters
    bit for bit; the hybridized Trainer's 1 eager update and 1 capture;
    the captured update's device ms and launches beside train_bf16's
    Adam update measured the same way; one LAMB update on the card held
    against the port's CPU update of bf16 copies of the same values, with
    planted controls (`_lamb_parity`)."""
    t0 = time.monotonic()
    x, y = _bf16_mlm_batch(torch)
    base = _mlm_build(mx, lambda: mx.models.bert_base(
        dropout=0.0, output_hidden=True, device="cuda:0"), 30522, 768,
        "bfloat16", "lamb", LAMB_PARAMS, LAMB_NO_WD)
    trainers = []

    def build():
        net, head, trainer = base()
        trainers.append((trainer, list(net.collect_params()) + [
            "loss." + n for n in head.collect_params()]))
        return net, head, trainer
    step = lambda n, h, t: _train_step(mx, n, h, t, (x,), y).mean()  # noqa
    run = phase_hybridize(torch, mx, att, cs, "train_lamb", build, step,
                          BF16_BATCH * SEQ, _flash_per_step(0))
    eager_tr, (hyb_tr, names) = trainers[0][0], trainers[1]
    del trainers[2:]
    counts = dict(captures=hyb_tr.captures, replays=hyb_tr.replays,
                  eager_updates=hyb_tr.eager_updates)
    no_wd = sum(getattr(p, "wd_mult", 1.0) == 0.0 for p in hyb_tr._params)
    parity = _lamb_parity(torch, mx, hyb_tr._params, names)
    lamb_update = _update_program_ms(torch, hyb_tr)
    del eager_tr, hyb_tr, trainers[:]
    gc.collect()
    torch.cuda.empty_cache()
    # train_bf16's Adam update, captured the same way and timed alike
    net, head, adam = _mlm_build(mx, lambda: mx.models.bert_base(
        dropout=0.0, output_hidden=True, device="cuda:0"), 30522, 768,
        "bfloat16")()
    net.hybridize(static_alloc=True, static_shape=True)
    head.hybridize()
    for _ in range(2):
        step(net, head, adam)
    _check(adam.captures == 1, "the Adam update was not captured")
    adam_update = _update_program_ms(torch, adam)
    del net, head, adam
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(phase="train_lamb", batch=[BF16_BATCH, SEQ],
               optimizer=dict(name="lamb", **LAMB_PARAMS),
               no_wd_params=no_wd, **_summary(run),
               step_ms=run["step_ms"], losses=run["losses"],
               eager_vs_hybridized=run["compare"], trainer=counts,
               flash_launches_per_replayed_step=run[
                   "profiled_launches_per_step"],
               update=dict(lamb=lamb_update, adam=adam_update),
               parity=parity,
               wall_s=time.monotonic() - t0)
    _emit(out)
    cmp = run["compare"]
    _check(cmp["losses_bit_equal"] and cmp["params_bit_equal"],
           "train_lamb: eager and hybridized differ: %r" % (cmp,))
    _check(counts["captures"] == 1 and counts["eager_updates"] == 1
           and counts["replays"] >= TRAIN_STEPS,
           "train_lamb: the Trainer did not capture once and replay: %r"
           % (counts,))
    _check(no_wd > 0, "train_lamb: no parameter without weight decay")
    _check(parity["ok"], "train_lamb: the card's LAMB update is not the "
           "CPU's: %r" % (parity,))
    failed = [k for k, v in parity["controls"].items() if v["ok"]]
    _check(not failed, "train_lamb: the LAMB parity check passed the "
           "planted updates %s" % failed)
    return out


OPT_BATCH, OPT_IN, OPT_HIDDEN, OPT_CLASSES = 64, 256, 512, 10
OPT_STEPS = 6
# the same 6 updates from the same gradients, card against CPU, f32: the
# two devices order and fuse the f32 arithmetic differently
OPT_UPDATE_TOL = 1e-5
# losses of the user block trained 6 steps on the card against its CPU
# copy (f32 products without TF32 on both)
OPT_LOSS_TOL = 1e-4
# a loss's value and input gradient in a hybridized block, card against
# CPU
OPT_LOSS_BLOCK_TOL = 1e-5
SGLD_ELEMS = 1 << 20
OPT_CASES = (
    # (case, optimizer, its parameters, dtype); every case also takes wd
    # 1e-4 and a FactorScheduler(2, 0.5)
    ("adagrad", "adagrad", dict(learning_rate=0.01), "float32"),
    ("adadelta", "adadelta", {}, "float32"),
    ("rmsprop", "rmsprop", dict(learning_rate=1e-3), "float32"),
    ("rmsprop_centered", "rmsprop",
     dict(learning_rate=1e-3, centered=True, clip_weights=1.0), "float32"),
    ("ftrl", "ftrl", dict(learning_rate=0.1, lamda1=1e-5), "float32"),
    ("signum", "signum", dict(learning_rate=1e-3), "float32"),
    ("signsgd", "signsgd", dict(learning_rate=1e-3), "float32"),
    ("lamb", "lamb", dict(learning_rate=1e-3), "float32"),
    ("adamax", "adamax", dict(learning_rate=2e-3), "float32"),
    ("nadam", "nadam", dict(learning_rate=1e-3), "float32"),
    ("sgld", "sgld", dict(learning_rate=1e-5), "float32"),
    ("test", "test", dict(learning_rate=0.01), "float32"),
    ("adam_mp", "adam", dict(learning_rate=1e-3, multi_precision=True),
     "float16"),
    ("lamb_mp", "lamb", dict(learning_rate=1e-3, multi_precision=True),
     "float16"),
)


def _opt_user_block(mx):
    """The phase's user block, written as a Gluon user writes one: a
    hybrid_forward over mx.nd ops, a child Dense and a weight of its own
    from params.get, its width filled by infer_shape."""
    class UserMLP(mx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.hidden = mx.gluon.nn.Dense(OPT_HIDDEN, in_units=OPT_IN)
                self.proj = self.params.get(
                    "proj", shape=(OPT_CLASSES, 0), allow_deferred_init=True)

        def infer_shape(self, x, *args):
            self.proj.shape = (OPT_CLASSES, OPT_HIDDEN)

        def hybrid_forward(self, F, x, proj):
            return F.FullyConnected(F.relu(self.hidden(x)), proj,
                                    no_bias=True, num_hidden=OPT_CLASSES)
    return UserMLP


def _opt_kwargs(mx, kw):
    return dict(kw, wd=1e-4, lr_scheduler=mx.lr_scheduler.FactorScheduler(
        step=2, factor=0.5))


def _opt_train(torch, mx, case, init, data, device, hybrid):
    """OPT_STEPS steps of the user block from `init` (values by parameter
    name) on `device`: the losses, the parameters after, the Trainer and
    the block."""
    _, name, kw, dtype = case
    mx.random.seed(0)
    net = _opt_user_block(mx)()
    net.initialize(ctx=device)
    x, y = (a.to(device) for a in data)
    with mx.autograd.pause():
        net(x[:1])
    for n, p in net.collect_params().items():
        p.set_data(init[n])
    if dtype != "float32":
        net.cast(dtype)
        x = x.to(getattr(torch, dtype))
    if hybrid:
        net.hybridize(static_alloc=True, static_shape=True)
    loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), name,
                               _opt_kwargs(mx, kw))
    losses = [_train_step(mx, net, loss, trainer, (x,), y).float().mean()
              for _ in range(OPT_STEPS)]
    return (torch.stack(losses).cpu(),
            [p.detach().clone() for p in trainer._params], trainer, net)


def _opt_update_err(torch, mx, case):
    """OPT_STEPS updates of 3 tensors from the same gradients, through the
    optimizer on the card and on the CPU: the largest error over each
    tensor's scale (f32), or in float16 ulps of the CPU weight (master
    copies)."""
    _, name, kw, dtype = case
    rs = np.random.RandomState(2)
    shapes = ((300, 40), (513,), (9, 7, 5))
    w0 = [rs.randn(*s).astype(np.float32) for s in shapes]
    gs = [[rs.randn(*s).astype(np.float32) for s in shapes]
          for _ in range(OPT_STEPS)]
    dt = getattr(torch, dtype)
    out = []
    for device in ("cuda:0", "cpu"):
        opt = mx.optimizer.create(name, **_opt_kwargs(mx, kw))
        ws = [torch.from_numpy(a).to(device, dt) for a in w0]
        sts = [opt.create_state_multi_precision(i, w)
               for i, w in enumerate(ws)]
        for step in range(OPT_STEPS):
            for i, w in enumerate(ws):
                opt.update_multi_precision(
                    i, w, torch.from_numpy(gs[step][i]).to(device, dt),
                    sts[i])
        out.append([w.float().cpu() for w in ws])
    if dtype == "float16":
        return max(((a - b).abs() / torch.exp2(torch.floor(torch.log2(
            b.abs().clamp_min(2.0 ** -14))) - 10)).max().item()
            for a, b in zip(*out))
    return max(((a - b).abs().max() / b.abs().max()).item()
               for a, b in zip(*out))


def _sgld_moments(torch, mx):
    """SGLD's captured update of SGLD_ELEMS zero weights from zero
    gradients (no wd): the change of each replay is the noise N(0, 1)
    sqrt(lr); its mean and variance over the weights, in sigmas of their
    estimates, and whether two replays drew the same noise."""
    lr = 1e-2
    p = mx.gluon.Parameter("sgld_w", shape=(SGLD_ELEMS,))
    p.initialize(init="zeros", ctx="cuda:0")
    trainer = mx.gluon.Trainer([p], "sgld", {"learning_rate": lr})
    p.grad = mx.autograd.grad_buffer(p)
    changes = []
    for _ in range(4):
        before = p.detach().clone()
        trainer.step(1)
        changes.append((p.detach() - before).double())
    n = float(SGLD_ELEMS)
    replayed = changes[2:]
    return dict(
        trainer=dict(captures=trainer.captures, replays=trainer.replays,
                     eager_updates=trainer.eager_updates),
        mean_sigmas=[abs(c.mean().item()) / math.sqrt(lr / n)
                     for c in replayed],
        var_sigmas=[abs(c.var().item() - lr) / (lr * math.sqrt(2.0 / n))
                    for c in replayed],
        replays_differ=not torch.equal(replayed[0], replayed[1]))


LOSS_BLOCKS = (
    # (loss class, its arguments, kind of inputs)
    ("L2Loss", {}, "reg"), ("L1Loss", {}, "reg"),
    ("SigmoidBinaryCrossEntropyLoss", {}, "binary"),
    ("SigmoidBCELoss", dict(from_sigmoid=True), "prob"),
    ("KLDivLoss", dict(from_logits=False), "dist"),
    ("HuberLoss", dict(rho=0.5), "reg"), ("HingeLoss", {}, "signed"),
    ("SquaredHingeLoss", {}, "signed"), ("LogisticLoss", {}, "signed"),
    ("TripletLoss", {}, "triplet"), ("CosineEmbeddingLoss", {}, "cosine"),
)


def _loss_inputs(torch, kind, rs):
    """(inputs that take a gradient, other inputs) for a loss."""
    f = np.float32
    n, k = OPT_BATCH, OPT_CLASSES
    pred = rs.randn(n, k).astype(f)
    if kind == "reg":
        other = [rs.randn(n, k)]
    elif kind == "binary":
        other = [rs.randint(0, 2, (n, k))]
    elif kind == "prob":
        pred = rs.rand(n, k).astype(f) * 0.9 + 0.05
        other = [rs.randint(0, 2, (n, k))]
    elif kind == "dist":
        lab = rs.rand(n, k)
        other = [lab / lab.sum(axis=1, keepdims=True)]
    elif kind == "signed":
        other = [rs.choice([-1.0, 1.0], (n, k))]
    elif kind == "triplet":
        return [pred, rs.randn(n, k).astype(f), rs.randn(n, k).astype(f)], []
    else:
        return [pred, rs.randn(n, k).astype(f)], [rs.choice([-1.0, 1.0], n)]
    return [pred], [a.astype(f) for a in other]


def _loss_block_errs(torch, mx):
    """Each loss as a hybridized block on the card (eager, capture, replay,
    each with its backward) against the same loss eagerly on the CPU: the
    value's and the input gradients' largest error over their scale."""
    rs = np.random.RandomState(3)
    out = {}
    for cls, kw, kind in LOSS_BLOCKS:
        diff, other = _loss_inputs(torch, kind, rs)
        res = {}
        for device, hybrid in (("cuda:0", True), ("cpu", False)):
            block = getattr(mx.gluon.loss, cls)(**kw)
            if hybrid:
                block.hybridize()
            for _ in range(3 if hybrid else 1):
                xs = [torch.from_numpy(a).to(device).requires_grad_()
                      for a in diff]
                with mx.autograd.record():
                    v = block(*xs, *[torch.from_numpy(a).to(device)
                                     for a in other])
                mx.autograd.backward(v)
            res[device] = [v.detach().cpu()] + [x.grad.cpu() for x in xs]
            if hybrid:
                g = block._cached_graph
                res["programs"] = (g.eager_calls, g.captures, g.replays)
        out[cls] = dict(
            err=max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                    .item() for a, b in zip(res["cuda:0"], res["cpu"])),
            programs=res["programs"])
    return out


def phase_optimizers(torch, mx):
    """The eleven optimizers the JAX package adds to SGD, NAG and Adam,
    RMSProp also centered, and Adam and LAMB with master copies of float16
    weights, each training a user block written with hybrid_forward under
    name_scope (a Dense child, a params.get weight filled by its own
    infer_shape) for 6 steps under a FactorScheduler, on the card eager
    and hybridized: bit for bit, the Trainer's 1 eager update, 1 capture
    and replays after; the same run on a CPU copy (losses within
    OPT_LOSS_TOL); 6 updates from the same gradients on the card and on
    the CPU (OPT_UPDATE_TOL of scale, master copies within one float16
    ulp); SGLD's replayed noise by its moments; and each new loss as a
    hybridized block on the card against the CPU."""
    t0 = time.monotonic()
    rs = np.random.RandomState(4)
    data = (torch.from_numpy(rs.randn(OPT_BATCH, OPT_IN).astype(np.float32)),
            torch.from_numpy(rs.randint(0, OPT_CLASSES, OPT_BATCH)
                             .astype(np.float32)))
    mx.random.seed(0)
    ref = _opt_user_block(mx)()
    ref.initialize(ctx="cpu")
    with mx.autograd.pause():
        ref(data[0][:1])
    init = {n: p.detach().clone() for n, p in ref.collect_params().items()}
    rows, failed = {}, []
    for case in OPT_CASES:
        e_loss, e_params, _, _ = _opt_train(torch, mx, case, init, data,
                                            "cuda:0", False)
        h_loss, h_params, tr, net = _opt_train(torch, mx, case, init, data,
                                               "cuda:0", True)
        c_loss, _, _, _ = _opt_train(torch, mx, case, init, data, "cpu",
                                     False)
        g = net._cached_graph
        row = dict(
            bit_equal=_same_bits(torch, e_loss, h_loss) and all(
                _same_bits(torch, a, b) for a, b in zip(e_params, h_params)),
            trainer=(tr.eager_updates, tr.captures, tr.replays),
            block=(g.eager_calls, g.captures, g.replays),
            lr_last=tr.learning_rate,
            cpu_loss_err=((h_loss - c_loss).abs()
                          / c_loss.abs().clamp_min(1e-30)).max().item(),
            losses=h_loss.tolist())
        if case[1] != "sgld":
            row["update_err"] = _opt_update_err(torch, mx, case)
        rows[case[0]] = row
        # SGLD's noise is each device's generator's: held by its moments
        ok = (row["bit_equal"] and row["trainer"] == (1, 1, OPT_STEPS - 2)
              and row["block"] == (1, 2, 2 * (OPT_STEPS - 2))
              and (case[1] == "sgld" or row["cpu_loss_err"] <= OPT_LOSS_TOL)
              and row.get("update_err", 0.0) <= (
                  1.0 if case[3] == "float16" else OPT_UPDATE_TOL))
        if not ok:
            failed.append(case[0])
    sgld = _sgld_moments(torch, mx)
    losses = _loss_block_errs(torch, mx)
    out = dict(phase="optimizers", steps=OPT_STEPS,
               shape=[OPT_BATCH, OPT_IN, OPT_HIDDEN, OPT_CLASSES],
               tolerances=dict(update=OPT_UPDATE_TOL, loss=OPT_LOSS_TOL,
                               loss_block=OPT_LOSS_BLOCK_TOL,
                               float16_update_ulps=1.0),
               optimizers=rows, sgld=sgld, loss_blocks=losses,
               failed=failed, wall_s=time.monotonic() - t0)
    _emit(out)
    _check(not failed, "optimizers: failed %r" % (failed,))
    _check(sgld["trainer"] == dict(captures=1, replays=2, eager_updates=1)
           and sgld["replays_differ"]
           and max(sgld["mean_sigmas"] + sgld["var_sigmas"]) <= 4.0,
           "optimizers: SGLD's replayed noise: %r" % (sgld,))
    bad = {k: v for k, v in losses.items()
           if v["err"] > OPT_LOSS_BLOCK_TOL or v["programs"] != (1, 2, 2)}
    _check(not bad, "optimizers: loss blocks off the CPU: %r" % (bad,))
    return out

def phase_decode_nmt(torch, mx, att):
    """transformer_nmt_base's cached decode on cuda:0: init_cache, then
    NMT_DECODE_STEPS greedy decode_steps, each step's logits held against
    the teacher-forced forward and a CPU copy."""
    src, _, _ = _nmt_data()
    rows = len(NMT_DECODE_VALID)
    mx.random.seed(0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = _nmt_model(mx, "cuda:0")
    s = torch.from_numpy(src[:rows]).cuda()
    valid = torch.tensor(NMT_DECODE_VALID, dtype=torch.float32,
                         device="cuda")

    def greedy():
        """Prefill and NMT_DECODE_STEPS greedy steps from NMT_BOS: the fed
        tokens (rows, steps), the logits (rows, steps, vocab) and CUDA
        events around the prefill and each step."""
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(NMT_DECODE_STEPS + 2)]
        events[0].record()
        cache = net.init_cache(s, valid, max_len=NMT_DECODE_STEPS,
                               mem_len=NMT_MEM_LEN)
        events[1].record()
        tok = torch.full((rows,), NMT_BOS, dtype=torch.long, device="cuda")
        fed, logits = [], []
        for i in range(NMT_DECODE_STEPS):
            fed.append(tok)
            out, cache = net.decode_step(
                tok, torch.full((rows,), i, device="cuda"), cache)
            events[i + 2].record()
            logits.append(out)
            tok = out.argmax(-1)
        return torch.stack(fed, 1), torch.stack(logits, 1), events

    with torch.inference_mode():
        greedy()                        # warm-up
        # device time by kernel over one prefill and its greedy steps
        _profile(torch, greedy, 1, top=8, phase="decode_nmt_profile",
                 rows=rows, steps=NMT_DECODE_STEPS)
        torch.cuda.synchronize()
        _reset_counts(att)              # the main path starts here
        t0 = time.perf_counter()
        fed, logits, events = greedy()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(zip(_COUNT_KEYS, _all_counts(att)))  # path ends
        prefill_ms = events[0].elapsed_time(events[1])
        step_ms = [events[i + 1].elapsed_time(events[i + 2])
                   for i in range(NMT_DECODE_STEPS)]
        # the teacher-forced forward over the fed prefix, on the card
        forced = net(s, fed, src_valid_length=valid)
        err_forced = (logits - forced).abs().max().item()
        cpu_net = _nmt_model(mx, "cpu")
        cpu_net.load_state_dict({k: v.cpu()
                                 for k, v in net.state_dict().items()})
        cache = cpu_net.init_cache(s.cpu(), valid.cpu(),
                                   max_len=NMT_DECODE_STEPS,
                                   mem_len=NMT_MEM_LEN)
        err_cpu = 0.0
        for i in range(NMT_DECODE_STEPS):
            out, cache = cpu_net.decode_step(fed[:, i].cpu(),
                                             torch.full((rows,), i), cache)
            err_cpu = max(err_cpu,
                          (logits[:, i].cpu() - out).abs().max().item())
    _emit(dict(phase="decode_nmt", model="transformer_nmt_base",
               dtype="float32", rows=rows, src_len=NMT_SEQ,
               src_valid_length=list(NMT_DECODE_VALID), mem_len=NMT_MEM_LEN,
               steps=NMT_DECODE_STEPS, prefill_ms=prefill_ms,
               step_ms=step_ms, step_ms_median=statistics.median(step_ms),
               wall_s=wall, tokens_per_s=rows * NMT_DECODE_STEPS / wall,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               distinct_tokens=int(fed.unique().numel()),
               forced_max_abs_err=err_forced, cpu_max_abs_err=err_cpu,
               tol=SERVE_TOL, launches=launches))
    _check(tuple(logits.shape) == (rows, NMT_DECODE_STEPS, NMT_VOCAB),
           "decode logits of shape %s" % (tuple(logits.shape),))
    _check(bool(torch.isfinite(logits).all()), "non-finite decode logits")
    # f32 logits of size ~1 through 6 + 6 layers, held as the served ones
    _check(err_forced <= SERVE_TOL, "decode logits differ from the "
           "teacher-forced forward by %g > %g" % (err_forced, SERVE_TOL))
    _check(err_cpu <= SERVE_TOL, "decode logits differ from the CPU copy "
           "by %g > %g" % (err_cpu, SERVE_TOL))
    _check(not any(launches.values()), "the decode steps launched flash "
           "kernels: %r" % (launches,))


def _greedy(torch, net, prompt, steps, device, feed=None,
            max_len=GEN_MAX_LEN, mem_len=max(GEN_BUCKETS)):
    """One request alone through the eager cached decode (init_cache at
    the engine's `max_len` and memory length `mem_len`, then decode_steps
    from NMT_BOS): each step's argmax, logits (on the CPU) and top-2 gap.
    With `feed`, step i + 1 is fed feed[i] instead of step i's argmax.
    Stops after an eos argmax."""
    src = torch.from_numpy(prompt[None]).to(device)
    cache = net.init_cache(src, torch.tensor([prompt.size], device=device),
                           max_len=max_len, mem_len=mem_len)
    tok = torch.tensor([NMT_BOS], device=device)
    toks, logits, gaps = [], [], []
    for i in range(steps):
        out, cache = net.decode_step(tok, torch.tensor([i], device=device),
                                     cache)
        row = out[0].float().cpu()
        top = row.topk(2).values
        toks.append(int(row.argmax()))
        logits.append(row)
        gaps.append(float(top[0] - top[1]))
        if toks[-1] == GEN_EOS:
            break
        nxt = feed[i] if feed is not None and i < len(feed) else toks[-1]
        tok = torch.tensor([nxt], device=device)
    return toks, torch.stack(logits), gaps


def _near_tie_compare(got, ref, gaps, tol):
    """Tokens `got` against the reference's `ref`: equal, or differing
    first at a step where the reference's top-2 gap is within `tol`, where
    the comparison stops.  Returns {steps compared, near_tie: None or
    {step, gap}}; raises on any other difference."""
    got = [int(t) for t in got]
    for i, (g, r) in enumerate(zip(got, ref)):
        if g != r:
            _check(gaps[i] <= tol, "token %d differs (%d, reference %d) "
                   "with a top-2 gap of %g > %g" % (i, g, r, gaps[i], tol))
            return dict(steps=i, near_tie=dict(step=i, gap=gaps[i]))
    _check(got == ref, "tokens %r differ from the reference's %r"
           % (got, ref))
    return dict(steps=len(got), near_tie=None)


def _gen_capacity(eng, prompts, seconds, max_new):
    """Closed-loop generation capacity (requests/s) with 2 x slots
    outstanding, as bench.py's measure_generate_capacity."""
    t0 = time.perf_counter()
    streams, done, i = [], 0, 0
    depth = max(4, eng.stats()["slots"] * 2)
    while time.perf_counter() < t0 + seconds:
        streams.append(eng.submit(prompts[i % len(prompts)],
                                  max_new_tokens=max_new))
        i += 1
        if len(streams) >= depth:
            streams.pop(0).result(timeout=GEN_RESULT_TIMEOUT)
            done += 1
    for s in streams:
        s.result(timeout=GEN_RESULT_TIMEOUT)
        done += 1
    return done / (time.perf_counter() - t0)


def _gen_open_loop(eng, prompts, rate, hi_deadline, rs):
    """Open-loop Poisson traffic at `rate` req/s for GEN_OPEN_S, as
    bench.py's _generate_overload: GEN_HI_FRAC on lane hi, the rest on
    lo (deadline twice hi's), budgets uniform in [3, GEN_MAX_NEW].
    Returns (offered, served, shed by lane, the offer's wall, the wall
    until every request resolved, streams)."""
    from incubator_mxnet_tpu_torch.serving import (DeadlineExceeded,
                                                   QueueFull, Shed)
    hi, lo = GEN_LANES
    served, shed, pending = {hi: 0, lo: 0}, {hi: 0, lo: 0}, []
    t0 = time.perf_counter()
    next_t, offered = t0, 0
    while True:
        now = time.perf_counter()
        if now >= t0 + GEN_OPEN_S:
            break
        if now < next_t:
            time.sleep(min(next_t - now, 0.002))
            continue
        next_t += rs.exponential(1.0 / rate)
        lane = hi if rs.rand() < GEN_HI_FRAC else lo
        dl = hi_deadline if lane == hi else 2.0 * hi_deadline
        mn = int(rs.randint(3, GEN_MAX_NEW + 1))
        offered += 1
        try:
            pending.append((lane, eng.submit(
                prompts[offered % len(prompts)], max_new_tokens=mn,
                deadline=dl, lane=lane)))
        except (Shed, QueueFull, DeadlineExceeded):
            shed[lane] += 1
    wall = time.perf_counter() - t0
    for lane, s in pending:
        try:
            s.result(timeout=GEN_RESULT_TIMEOUT)
            served[lane] += 1
        except (Shed, QueueFull, DeadlineExceeded):
            shed[lane] += 1
    return (offered, served, shed, wall, time.perf_counter() - t0,
            [s for _, s in pending])


def _gen_after_close(torch, eng, streams, ptrs, events):
    """What close() must leave: every stream resolved, no unfinished
    task, the cache on its warmup storage, no donation copy."""
    leaves = eng._state.leaves()
    out = dict(streams_resolved=all(s.done() for s in streams),
               unfinished_tasks=eng._q.unfinished_tasks,
               cache_ptrs_stable={k: t.data_ptr()
                                  for k, t in leaves.items()} == ptrs,
               donation_copy=events.get("gen.donation_copy"))
    _check(out["streams_resolved"], "a stream is unresolved after close()")
    _check(out["unfinished_tasks"] == 0, "%d unfinished tasks after close()"
           % out["unfinished_tasks"])
    _check(out["cache_ptrs_stable"], "a cache leaf moved since warmup")
    _check(out["donation_copy"] == 0, "gen.donation_copy = %d"
           % out["donation_copy"])
    return out


def _gen_traffic(torch, eng, mode, prompts, rate, hi_deadline, ptrs,
                 events, device_ms):
    """One open-loop run on `eng` and its checks after close(); emits
    the mode's line.  Rates of tokens and steps are over the wall until
    the last request resolved.  `device_share_est` is the device time of
    the programs the run replayed, from their times measured alone
    (`device_ms`: ms of a decode step, and of a prefill, the traffic's
    mean over its buckets, plus a join), over that wall."""
    hi, lo = GEN_LANES
    _check(events.get("gen.donation_copy") == 0, "gen.donation_copy "
           "before %s traffic" % mode)
    events.reset()      # this mode's latency rings and counters only
    offered, served, shed, wall, total, streams = _gen_open_loop(
        eng, prompts, rate, hi_deadline, np.random.RandomState(17))
    captures = events.get("serve.traces")
    tokens = events.get("gen.tokens")
    ttft = {r["labels"]["lane"]: r for r in events.labeled_percentiles(
        "gen.ttft_us", (50, 99))}
    it = events.percentiles("gen.intertoken_us", (50, 99))
    step_us = events.percentiles("gen.step_us", (50, 99))
    prefill_us = events.percentiles("gen.prefill_us", (50, 99))
    steps = events.get("gen.steps")
    memory = torch.cuda.memory_allocated()
    eng.close()
    closed = _gen_after_close(torch, eng, streams, ptrs, events)
    row = dict(phase="generate_nmt", part="traffic", mode=mode,
               offered=offered, offered_rps=offered / wall,
               target_rps=rate, wall_s=wall, total_wall_s=total,
               served=served, shed=shed,
               achieved_rps=sum(served.values()) / total,
               tokens=tokens, tokens_per_s=tokens / total,
               ttft_hi_p50_ms=ttft.get(hi, {}).get("p50", 0) / 1e3,
               ttft_hi_p99_ms=ttft.get(hi, {}).get("p99", 0) / 1e3,
               ttft_lo_p99_ms=ttft.get(lo, {}).get("p99", 0) / 1e3,
               intertoken_p50_ms=it.get("p50", 0) / 1e3,
               intertoken_p99_ms=it.get("p99", 0) / 1e3,
               shed_fraction=sum(shed.values()) / max(1, offered),
               steps=steps, slots_live_mean=tokens / max(1, steps),
               step_wall_ms_p50=step_us.get("p50", 0) / 1e3,
               step_wall_ms_p99=step_us.get("p99", 0) / 1e3,
               prefills=events.get("gen.prefills"),
               prefill_join_ms_p50=prefill_us.get("p50", 0) / 1e3,
               prefill_join_ms_p99=prefill_us.get("p99", 0) / 1e3,
               device_share_est=(
                   steps * device_ms["step"] + events.get("gen.prefills")
                   * device_ms["prefill_join"]) / (total * 1e3),
               captures_during_traffic=captures,
               memory_allocated=memory, **closed)
    _emit(row)
    _check(captures == 0, "%d captures during %s traffic" % (captures, mode))
    _check(tokens > 0, "no token during %s traffic" % mode)
    return row


def phase_generate_nmt(torch, mx, att, cs):
    """transformer_nmt_base behind GenerationEngine on cuda:0: warmup
    (the captured program set), parity of 8 requests with the eager
    greedy loop and, for the first steps of 2, with a CPU copy; the
    replayed decode step against the same function run eagerly, and its
    profile; closed-loop capacity; open-loop traffic at twice it,
    continuous and drain batching; the engine's state after close()."""
    from incubator_mxnet_tpu_torch.monitor import events
    from incubator_mxnet_tpu_torch.serving import GenerationEngine
    mx.random.seed(0)
    torch.cuda.empty_cache()
    net = _nmt_model(mx, "cuda:0")
    _reset_counts(att)                  # the phase's path starts here
    conv0 = cs.conv1x1_stats_launches

    def engine(continuous):
        return GenerationEngine(
            net, bos=NMT_BOS, eos=GEN_EOS, slots=GEN_SLOTS,
            max_len=GEN_MAX_LEN, prompt_buckets=GEN_BUCKETS,
            lanes=GEN_LANES, lane_quotas=GEN_QUOTAS,
            queue_cap=GEN_QUEUE_CAP, continuous=continuous)

    def warm(eng, mode):
        t0 = events.get("serve.traces")
        w = eng.warmup()
        captures = events.get("serve.traces") - t0
        ptrs = {k: t.data_ptr() for k, t in eng._state.leaves().items()}
        _emit(dict(phase="generate_nmt", part="warmup", mode=mode,
                   wall_s=w["wall_s"], bucket_wall_s=w["bucket_wall_s"],
                   captures=captures, kv_cache_bytes=w["kv_cache"],
                   memory_allocated=torch.cuda.memory_allocated()))
        _check(captures == len(GEN_BUCKETS) + 2, "warmup made %d captures, "
               "want %d" % (captures, len(GEN_BUCKETS) + 2))
        return ptrs

    eng = engine(True)
    ptrs = warm(eng, "continuous")

    # parity: 8 requests together against each alone, eager on the card
    rs = np.random.RandomState(0)
    prompts = [rs.randint(3, NMT_VOCAB, (n,)).astype(np.int32)
               for n in GEN_PARITY_LENGTHS]
    streams = [eng.submit(p, max_new_tokens=m)
               for p, m in zip(prompts, GEN_PARITY_NEW)]
    got = [s.result(timeout=GEN_RESULT_TIMEOUT) for s in streams]
    cpu_net = _nmt_model(mx, "cpu")
    cpu_net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    requests, cpu_rows = [], []
    with torch.no_grad():
        for i, (p, m, g) in enumerate(zip(prompts, GEN_PARITY_NEW, got)):
            ref, logits, gaps = _greedy(torch, net, p, m, "cuda:0")
            requests.append(dict(prompt_len=int(p.size), max_new=m,
                                 tokens=len(g), distinct=len(set(g.tolist())),
                                 **_near_tie_compare(g, ref, gaps,
                                                     SERVE_TOL)))
            if i < GEN_CPU_REQUESTS:
                # both fed the engine's tokens, so that the logits compare
                feed = [int(t) for t in g]
                _, card_logits, _ = _greedy(torch, net, p, GEN_CPU_STEPS,
                                            "cuda:0", feed)
                cpu_ref, cpu_logits, cpu_gaps = _greedy(
                    torch, cpu_net, p, GEN_CPU_STEPS, "cpu", feed)
                err = (card_logits - cpu_logits).abs().max().item()
                cpu_rows.append(dict(prompt_len=int(p.size),
                                     logits_max_abs_err=err,
                                     **_near_tie_compare(
                                         g[:GEN_CPU_STEPS], cpu_ref,
                                         cpu_gaps, SERVE_TOL)))
                _check(err <= SERVE_TOL, "decode logits differ from the CPU "
                       "copy by %g > %g" % (err, SERVE_TOL))
    del cpu_net
    _emit(dict(phase="generate_nmt", part="parity", tol=SERVE_TOL,
               requests=requests, cpu=cpu_rows,
               memory_allocated=torch.cuda.memory_allocated()))
    for g, m in zip(got, GEN_PARITY_NEW):
        _check(1 <= g.size <= m and (g.size == m or g[-1] == GEN_EOS),
               "a request of budget %d returned %d tokens" % (m, g.size))

    # the decode step at 32 slots: replayed, and the same function eager
    with eng._exec_lock, torch.no_grad():
        prog = eng._programs["decode"]

        def step():                     # the engine's step on the device
            prog.replay()
            eng._read_tokens()

        def event_ms(fn):
            times = []
            for _ in range(GEN_TIMED_STEPS):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                fn()
                e1.record()
                e1.synchronize()
                times.append(e0.elapsed_time(e1))
            return statistics.median(times)

        def wall_ms(fn):
            times = []
            for _ in range(GEN_TIMED_STEPS):
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(times)

        eager_fn = eng._decode_fn()
        eager_fn()
        torch.cuda.synchronize()
        replay_ms, step_wall_ms = event_ms(prog.replay), wall_ms(step)
        prefill_ms = {b: event_ms(eng._programs[("prefill", b)].replay)
                      for b in GEN_BUCKETS}
        join_ms = event_ms(eng._programs["join"].replay)
        eager_ms = event_ms(eager_fn)
        eager_wall_ms = wall_ms(lambda: (eager_fn(), eng._read_tokens()))
        rows, wall_us = _device_kernels(torch, step, GEN_PROFILED_STEPS)
    device_us = sum(r[0] for r in rows)
    # the cache write-backs are device-to-device copies ("memcpy128"
    # kernels in a replay); the token read is the one to the host
    copies = [dict(kernel=k[:100], us=us / GEN_PROFILED_STEPS,
                   calls=n / GEN_PROFILED_STEPS)
              for us, k, n in rows if "memcpy" in k.lower()]
    _emit(dict(phase="generate_nmt_profile", slots=GEN_SLOTS,
               max_len=GEN_MAX_LEN, steps=GEN_PROFILED_STEPS,
               wall_us=wall_us, device_us=device_us,
               busy_share=device_us / wall_us,
               device_ms_per_step=device_us / GEN_PROFILED_STEPS / 1e3,
               kernels_per_step=sum(r[2] for r in rows) / GEN_PROFILED_STEPS,
               top=[dict(kernel=k[:100], us=us / GEN_PROFILED_STEPS,
                         calls=n / GEN_PROFILED_STEPS,
                         share=us / device_us)
                    for us, k, n in rows[:10]],
               copies=copies,
               copies_us_per_step=sum(c["us"] for c in copies)))
    decode = dict(phase="generate_nmt", part="decode_step",
                  slots=GEN_SLOTS, max_len=GEN_MAX_LEN,
                  steps=GEN_TIMED_STEPS, replay_ms=replay_ms,
                  step_wall_ms=step_wall_ms, eager_ms=eager_ms,
                  eager_step_wall_ms=eager_wall_ms,
                  eager_over_replay=eager_ms / replay_ms,
                  prefill_replay_ms=prefill_ms, join_replay_ms=join_ms,
                  busy_share=device_us / wall_us)
    _emit(decode)

    # capacity, then open-loop traffic at twice it, both modes
    rs = np.random.RandomState(0)
    traffic = [rs.randint(3, NMT_VOCAB, (int(n),)).astype(np.int32)
               for n in rs.randint(1, GEN_MAX_LEN + 1, 64)]
    buckets = [eng._bucket_for(p.size) for p in traffic]
    device_ms = dict(step=replay_ms, prefill_join=join_ms + sum(
        prefill_ms[b] for b in buckets) / len(buckets))
    capacity = _gen_capacity(eng, traffic, GEN_CAPACITY_S, GEN_MAX_NEW)
    svc = 1.0 / max(capacity / GEN_SLOTS, 1e-6)
    hi_deadline = max(0.5, 3.5 * svc)
    _emit(dict(phase="generate_nmt", part="capacity", rps=capacity,
               seconds=GEN_CAPACITY_S, max_new=GEN_MAX_NEW,
               hi_deadline_s=hi_deadline, lo_deadline_s=2 * hi_deadline))
    modes = {"continuous": _gen_traffic(torch, eng, "continuous", traffic,
                                        2 * capacity, hi_deadline, ptrs,
                                        events, device_ms)}
    drain = engine(False)
    dptrs = warm(drain, "drain")
    modes["drain"] = _gen_traffic(torch, drain, "drain", traffic,
                                  2 * capacity, hi_deadline, dptrs, events,
                                  device_ms)
    launches = dict(zip(_COUNT_KEYS, _all_counts(att)),
                    conv=cs.conv1x1_stats_launches - conv0)
    summary = dict(phase="generate_nmt", part="summary",
                   model="transformer_nmt_base", dtype="float32",
                   slots=GEN_SLOTS, max_len=GEN_MAX_LEN,
                   prompt_buckets=list(GEN_BUCKETS), capacity_rps=capacity,
                   replay_ms=replay_ms, eager_ms=eager_ms,
                   busy_share=decode["busy_share"],
                   ttft_hi_p99_ms={m: r["ttft_hi_p99_ms"]
                                   for m, r in modes.items()},
                   continuous_over_drain_ttft_hi_p99=(
                       modes["continuous"]["ttft_hi_p99_ms"]
                       / max(modes["drain"]["ttft_hi_p99_ms"], 1e-9)),
                   tokens_per_s={m: r["tokens_per_s"]
                                 for m, r in modes.items()},
                   launches=launches)
    _emit(summary)
    _check(not any(launches.values()), "the generation path launched port "
           "kernels: %r" % (launches,))
    return summary


def _shape_rows(fwd_rows, bwd_rows, kernel, cases):
    """One kernel's times at a path's shapes `cases`, by "non_causal" and
    "causal": {ms, device_ms, plain_ms, bound_ms, bound_by, library_ms}
    with library_ms the device time of SDPA (forward) or of its backward
    alone (the dQ and dK/dV kernels together)."""
    out = {}
    for case in cases:
        if kernel == "fwd":
            r, pre = fwd_rows[case], ""
            library_ms = r["library_device_ms"]
        else:
            r, pre = bwd_rows[case], kernel + "_"
            library_ms = r["library_ms"]
        out["causal" if case[-1] else "non_causal"] = dict(
            ms=r[pre + "ms"], device_ms=r[pre + "device_ms"],
            plain_ms=r[pre + "plain_ms"], bound_ms=r[pre + "bound_ms"],
            bound_by=r[pre + "bound_by"], library_ms=library_ms)
    return out


# template arguments of a mangled kernel name: float, bf16, int, bool
_PTX_ARG = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16",
            "Lb0E": "false", "Lb1E": "true"}


def _ptxas(reports):
    """{"kernel<args>": {registers, spill_store_bytes}} from ptxas's
    report: each "Compiling entry function" line names a template instance
    by its mangled name, the spill line and the "Used N registers" line
    that follow are its own."""
    out, name = {}, None
    for log in reports.values():
        for line in log.splitlines():
            m = re.search(r"(flash_[a-z_]+_kernel|conv1x1_stats(?:_tc)?_kernel"
                          r"|stats_reduce_kernel|mxt_nms_(?:count|mask|scan)_kernel)"
                          r"((?:I(?:f|13__nv_bfloat16|6__half|Li\d+E"
                          r"|Lb[01]E)+E)?)",
                          line)
            if "Compiling entry function" in line and m:
                args = [_PTX_ARG.get(a, a[2:-1]) for a in re.findall(
                    r"13__nv_bfloat16|6__half|Li\d+E|Lb[01]E|f",
                    m.group(2))]
                name = m.group(1) + ("<%s>" % ", ".join(args) if args
                                     else "")
                out[name] = {}
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and name:
                out[name]["spill_store_bytes"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                out[name]["registers"], name = int(m.group(1)), None
    return out



# -- ndarray: the mx.nd surface on the card ---------------------------------

ND_BLOCK_STEPS = 2
ND_DISPATCH_CALLS = 1000


def _flash_counts(att):
    return dict(zip(("fwd", "dq", "dkv"), _all_counts(att)[:3]))


def _bitwise(torch, pairs):
    """Names of the (name, a, b) tensor pairs whose bits differ."""
    return [name for name, a, b in pairs if not _same_bits(torch, a, b)]


def _nd_bert(torch, mx, att, rs):
    """BERT-base through the NDArray boundary: the forward fed an NDArray
    against the same call fed the tensor, then one Adam step from two
    copies of one start, one fed NDArrays (loss.backward() on the NDArray
    loss) and one fed tensors: every gradient and updated parameter bit
    for bit.  Returns the launches of the forward and of the step."""
    nd = mx.nd
    tokens = rs.randint(0, 30522, (TRAIN_BATCH, SEQ)).astype(np.int32)
    labels = rs.randint(0, 30522, (TRAIN_BATCH, SEQ)).astype(np.float32)
    mx.random.seed(0)
    nets, heads, trainers, named = [], [], [], []
    for _ in range(2):
        net = mx.models.bert_base(dropout=0.0, output_hidden=True,
                                  device="cuda:0")
        head = mx.models.FusedMLMCELoss(30522, 768, device="cuda:0")
        if nets:
            net.load_state_dict(nets[0].state_dict())
            head.load_state_dict(heads[0].state_dict())
        params = dict(net.collect_params())
        params.update({"loss." + n: p
                       for n, p in head.collect_params().items()})
        nets.append(net)
        heads.append(head)
        named.append(params)
        trainers.append(mx.gluon.Trainer(params, "adam",
                                         {"learning_rate": 1e-4}))
    x_nd = nd.array(tokens, ctx=mx.gpu(0), dtype="int32")
    y_nd = nd.array(labels, ctx=mx.gpu(0))
    x_t, y_t = x_nd._data.clone(), y_nd._data.clone()
    _check(isinstance(x_nd, nd.NDArray) and x_nd.context == mx.gpu(0)
           and x_nd._data.dtype == torch.int32, "nd.array on the card")
    with mx.autograd.pause():
        _reset_counts(att)              # the NDArray forward
        out_nd = nets[0](x_nd)
        torch.cuda.synchronize()
        fwd = _flash_counts(att)
        out_t = nets[0](x_t)
    _check(isinstance(out_nd, nd.NDArray), "bert_base fed an NDArray "
           "returned %s" % type(out_nd).__name__)
    fwd_same = _same_bits(torch, out_nd._data, out_t)

    _reset_counts(att)                  # the NDArray training step
    with mx.autograd.record():
        loss_nd = heads[0](nets[0](x_nd), y_nd)
    loss_nd.backward()
    trainers[0].step(TRAIN_BATCH)
    torch.cuda.synchronize()
    step = _flash_counts(att)
    _check(isinstance(loss_nd, nd.NDArray), "the loss block fed NDArrays "
           "returned %s" % type(loss_nd).__name__)
    loss_t = _train_step(mx, nets[1], heads[1], trainers[1], (x_t,), y_t)
    torch.cuda.synchronize()
    pairs = [("loss", loss_nd._data.detach(), loss_t)]
    for name, p in named[0].items():
        q = named[1][name]
        pairs.append(("grad:" + name, p.grad, q.grad))
        pairs.append(("param:" + name, p.detach(), q.detach()))
    differ = _bitwise(torch, pairs)
    row = dict(part="bert_base", batch=TRAIN_BATCH, seq=SEQ,
               layers=len(nets[0].encoder.layers),
               forward_bit_equal=fwd_same, forward_launches=fwd,
               step_launches=step, step_tensors=len(pairs),
               step_bits_differ=differ[:8], step_bits_differ_count=len(
                   differ), loss_mean=loss_t.mean().item())
    del nets, heads, trainers, named, out_nd, out_t, loss_nd, loss_t, pairs
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _nd_block(mx, x, t, weights, gamma, beta):
    """One recorded forward of the imperative attention block written in
    nd ops: three projections, nd.contrib.flash_attention over 12 heads,
    the output projection, LayerNorm of the residual, and the mean squared
    error against t."""
    nd = mx.nd
    wq, bq, wk, bk, wv, bv, wo, bo = weights
    units = x.shape[-1]
    with mx.autograd.record():
        q = nd.FullyConnected(x, wq, bq, num_hidden=units, flatten=False)
        k = nd.FullyConnected(x, wk, bk, num_hidden=units, flatten=False)
        v = nd.FullyConnected(x, wv, bv, num_hidden=units, flatten=False)
        a = nd.contrib.flash_attention(q, k, v, num_heads=12)
        o = nd.FullyConnected(a, wo, bo, num_hidden=units, flatten=False)
        h = nd.LayerNorm(x + o, gamma, beta)
        loss = nd.mean(nd.square(h - t))
    return loss


def _nd_block_run(torch, mx, att, arrays, plain):
    """ND_BLOCK_STEPS steps of the block (record, backward, nd.adam_update
    of each weight with out=(w, m, v)): the losses, each step's gradients,
    the final weights, the step ms (CUDA events) and the launches per
    step.  With `plain`, attention takes its plain version on the card."""
    nd = mx.nd
    x_np, t_np, w_np = arrays
    x, t = nd.array(x_np, ctx=mx.gpu(0)), nd.array(t_np, ctx=mx.gpu(0))
    weights = [nd.array(w, ctx=mx.gpu(0)) for w in w_np]
    for w in weights:
        w.attach_grad()
    states = [(nd.zeros(w.shape, ctx=mx.gpu(0)),
               nd.zeros(w.shape, ctx=mx.gpu(0))) for w in weights]
    gamma = nd.ones((x.shape[-1],), ctx=mx.gpu(0))
    beta = nd.zeros((x.shape[-1],), ctx=mx.gpu(0))
    losses, grads, ms, launches = [], [], [], []
    ctx = _plain_backward(att, torch.matmul, forward=True) if plain \
        else contextlib.nullcontext()
    with ctx:
        for _ in range(ND_BLOCK_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            _reset_counts(att)
            start.record()
            loss = _nd_block(mx, x, t, weights, gamma, beta)
            loss.backward()
            step_grads = [w.grad._data.clone() for w in weights]
            for w, (m, v) in zip(weights, states):
                nd.adam_update(w, w.grad, m, v, out=(w, m, v), lr=1e-4)
            end.record()
            end.synchronize()
            launches.append(_flash_counts(att))
            ms.append(start.elapsed_time(end))
            losses.append(loss._data.detach().clone())
            grads.append(step_grads)
    return dict(losses=losses, grads=grads, ms=ms, launches=launches,
                weights=[w._data.detach().clone() for w in weights])


def _nd_block_phase(torch, mx, att, rs):
    """The imperative block at BERT-base width, through the kernels and
    through the plain attention, held to the flash rows' tolerances."""
    B, T, C = TRAIN_BATCH, SEQ, 768
    x_np = rs.randn(B, T, C).astype(np.float32)
    t_np = rs.randn(B, T, C).astype(np.float32)
    w_np = []
    for _ in range(4):
        w_np.append((rs.randn(C, C) * 0.02).astype(np.float32))
        w_np.append((rs.randn(C) * 0.02).astype(np.float32))
    arrays = (x_np, t_np, w_np)
    kern = _nd_block_run(torch, mx, att, arrays, plain=False)
    ref = _nd_block_run(torch, mx, att, arrays, plain=True)
    names = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")
    loss_err = max((a - b).abs().item()
                   for a, b in zip(kern["losses"], ref["losses"]))
    loss_ratio = max(((a - b).abs() / _out_tolerance(torch, b, "float32"))
                     .max().item()
                     for a, b in zip(kern["losses"], ref["losses"]))
    # each gradient's scale is floored at 1e-3 of the step's largest, as
    # train's rule does: the key bias has a gradient of exactly 0 in exact
    # arithmetic (softmax ignores a shift of a row's scores), so both
    # routes give it rounding noise, held to the block's scale
    grad_ratio, worst = 0.0, None
    for step, (gk, gr) in enumerate(zip(kern["grads"], ref["grads"])):
        floor = 1e-3 * max(b.abs().max().item() for b in gr)
        for name, a, b in zip(names, gk, gr):
            tol = BWD_TOL * max(b.abs().max().item(), floor)
            r = (a - b).abs().max().item() / tol
            if r >= grad_ratio:
                grad_ratio, worst = r, "step %d %s" % (step, name)
    weight_ratio, worst_w = 0.0, None
    for name, a, b in zip(names, kern["weights"], ref["weights"]):
        r = ((a - b).abs() / _grad_tolerance(torch, b, "float32")).max() \
            .item()
        if r >= weight_ratio:
            weight_ratio, worst_w = r, name
    row = dict(part="imperative_block", batch=B, seq=T, units=C, heads=12,
               steps=ND_BLOCK_STEPS, optimizer="nd.adam_update lr 1e-4",
               losses=[v.item() for v in kern["losses"]],
               loss_max_abs_err=loss_err, loss_err_over_tol=loss_ratio,
               worst_grad_err_over_tol=grad_ratio, worst_grad=worst,
               worst_weight_err_over_tol=weight_ratio, worst_weight=worst_w,
               step_ms=kern["ms"], plain_step_ms=ref["ms"],
               launches_per_step=kern["launches"],
               plain_launches_per_step=ref["launches"])
    return row


def _nd_penalty(torch, mx, att, rs):
    """A gradient penalty through nd.FullyConnected(768 -> 3072),
    nd.Activation(tanh) and nd.FullyConnected(3072 -> 768) at batch
    8 x 512: autograd.grad(create_graph=True), then a backward of the
    penalty; its weight gradients against torch.autograd.grad over the
    same tensors, and its ms (CUDA events, median of 5)."""
    import torch.nn.functional as F
    nd = mx.nd
    B, T, C, H = TRAIN_BATCH, SEQ, 768, 3072
    x_np = rs.randn(B, T, C).astype(np.float32)
    w_np = [(rs.randn(H, C) * 0.02).astype(np.float32),
            (rs.randn(H) * 0.02).astype(np.float32),
            (rs.randn(C, H) * 0.02).astype(np.float32),
            (rs.randn(C) * 0.02).astype(np.float32)]
    x = nd.array(x_np, ctx=mx.gpu(0))
    ws = [nd.array(w, ctx=mx.gpu(0)) for w in w_np]
    for a in [x] + ws:
        a.attach_grad()

    def nd_step():
        with mx.autograd.record():
            h = nd.Activation(nd.FullyConnected(x, ws[0], ws[1],
                                                num_hidden=H, flatten=False),
                              act_type="tanh")
            y = nd.FullyConnected(h, ws[2], ws[3], num_hidden=C,
                                  flatten=False)
            gx, = mx.autograd.grad(nd.sum(y), [x], create_graph=True)
            pen = nd.sum(nd.square(gx))
        pen.backward()
        return pen

    pen = nd_step()
    got = [w.grad._data.clone() for w in ws]
    dev = x.context
    tx = torch.tensor(x_np, device=dev, requires_grad=True)
    tws = [torch.tensor(w, device=dev, requires_grad=True) for w in w_np]
    h = torch.tanh(F.linear(tx, tws[0], tws[1]))
    y = F.linear(h, tws[2], tws[3])
    gx, = torch.autograd.grad(y.sum(), tx, create_graph=True)
    ref_pen = gx.square().sum()
    # the last bias does not reach the penalty: its gradient is zero
    ref = [torch.zeros_like(w) if g is None else g for w, g in zip(
        tws, torch.autograd.grad(ref_pen, tws, allow_unused=True))]
    ratio = max(((a - b).abs() / _grad_tolerance(torch, b, "float32"))
                .max().item() for a, b in zip(got, ref))
    ms = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        nd_step()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return dict(part="grad_penalty", batch=B, seq=T, units=C, hidden=H,
                penalty=pen.asscalar().item(),
                penalty_abs_err=abs(pen.asscalar().item()
                                    - ref_pen.item()),
                worst_grad_err_over_tol=ratio,
                grads_bit_equal=all(_same_bits(torch, a, b)
                                    for a, b in zip(got, ref)),
                ms=ms, ms_median=statistics.median(ms))


def _host_us(fn, calls=ND_DISPATCH_CALLS):
    """Median host microseconds of one call, over `calls` warm calls."""
    for _ in range(50):
        fn()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(times)


def _nd_dispatch(torch, mx):
    """Host cost of the registry dispatch on (768,) operands."""
    nd = mx.nd
    a = nd.array(np.arange(768, dtype=np.float32), ctx=mx.gpu(0))
    b = nd.array(np.ones(768, np.float32), ctx=mx.gpu(0))
    ta, tb = a._data, b._data
    row = dict(part="dispatch", shape=[768], calls=ND_DISPATCH_CALLS,
               nd_broadcast_add_us=_host_us(lambda: nd.broadcast_add(a, b)),
               ndarray_add_us=_host_us(lambda: a + b),
               torch_add_us=_host_us(lambda: torch.add(ta, tb)))
    torch.cuda.synchronize()
    return row


def phase_ndarray(torch, mx, att):
    """The mx.nd surface on the card: BERT-base through the NDArray
    boundary, an imperative attention block in nd ops, a create_graph
    gradient penalty and the dispatch cost; returns each flash kernel's
    launches in the NDArray paths."""
    gc.collect()
    torch.cuda.empty_cache()
    rs = np.random.RandomState(0)
    t0 = time.monotonic()
    bert = _nd_bert(torch, mx, att, rs)
    block = _nd_block_phase(torch, mx, att, rs)
    penalty = _nd_penalty(torch, mx, att, rs)
    dispatch = _nd_dispatch(torch, mx)
    _emit(dict(phase="ndarray", seconds=time.monotonic() - t0,
               parts=[bert, block, penalty, dispatch]))
    _check(bert["forward_bit_equal"], "bert_base fed an NDArray differs "
           "from the same call fed the tensor")
    _check(not bert["step_bits_differ"], "the NDArray training step "
           "differs from the tensor one in %d tensors, e.g. %s"
           % (bert["step_bits_differ_count"], bert["step_bits_differ"]))
    layers = bert["layers"]
    _check(bert["forward_launches"] == dict(fwd=layers, dq=0, dkv=0),
           "the NDArray forward launched %r" % bert["forward_launches"])
    _check(bert["step_launches"] == dict(fwd=layers, dq=layers, dkv=layers),
           "the NDArray step launched %r" % bert["step_launches"])
    _check(block["loss_err_over_tol"] <= 1.0, "the imperative block's loss "
           "is %g of its tolerance from the plain route"
           % block["loss_err_over_tol"])
    _check(block["worst_grad_err_over_tol"] <= 1.0, "gradient %s of the "
           "imperative block is %g of its tolerance from the plain route"
           % (block["worst_grad"], block["worst_grad_err_over_tol"]))
    _check(block["worst_weight_err_over_tol"] <= 1.0, "updated weight %s "
           "of the imperative block is %g of its tolerance from the plain "
           "route" % (block["worst_weight"],
                      block["worst_weight_err_over_tol"]))
    _check(all(c == dict(fwd=1, dq=1, dkv=1)
               for c in block["launches_per_step"]),
           "an imperative block step launched %r"
           % block["launches_per_step"])
    _check(all(c == dict(fwd=0, dq=0, dkv=0)
               for c in block["plain_launches_per_step"]),
           "the plain route launched a kernel")
    _check(all(math.isfinite(v) for v in block["losses"]),
           "non-finite block loss %r" % block["losses"])
    _check(penalty["worst_grad_err_over_tol"] <= 1.0, "the penalty's "
           "weight gradients are %g of their tolerance from torch's"
           % penalty["worst_grad_err_over_tol"])
    return {k: dict(bert_forward=bert["forward_launches"][k],
                    bert_step=bert["step_launches"][k],
                    imperative_block=sum(c[k] for c in
                                         block["launches_per_step"]))
            for k in ("fwd", "dq", "dkv")}


# -- detection: the NMS kernel, SSD-512 and Faster R-CNN (bench.py 3a, 3b) --

# kernel_nms: Proposal's shape (2 images x 2000 proposals, IoU > 0.7 by the
# +1 convention, the first 1000 kept), box_nms's (8 x 4096 boxes,
# class-aware over 20 classes, valid_thresh 0, every rank), and repeated
# boxes with tied scores.  Keep flags and kept positions must equal the
# plain version's exactly: both decide `iou > thresh` on the same f32
# arithmetic (the kernel without FMA contraction).
NMS_PROPOSAL = (2, 2000, 0.7, 1000)
NMS_BOX = (8, 4096, 0.5)
# MultiBoxDetection's: SSD-512's anchors, class-aware over 20 classes, IoU
# 0.5, flags on a sorted prefix of 1.1-1.5 % of each image (the trained
# batch of train_ssd had 2,569 boxes over its 0.01 score, 1.3 %)
NMS_MULTIBOX = (8, 24564, 0.5, (0.011, 0.015))
# flags that are no prefix: every other box and a random third of the rest
NMS_INTERLEAVED = (2, 2000, 0.5)
# a pair's IoU: 4 min/max, 2 subtractions and 2 max for the overlap, its
# product, the union's add and subtract, the division and the compare
NMS_PAIR_OPS = 13
# bench.py config 3a: ssd_512_vgg16(classes=20), batch 8, 512 x 512 bf16
# images (f32 parameters), one gt box [1, .2, .2, .7, .7] per image, SGD
# lr 0.01 momentum 0.9, net and SSDTrainLoss hybridized
SSD_BATCH = 8
SSD_SIZE = 512
SSD_CLASSES = 20
SSD_ANCHORS = 24564
# SSD's batch-1 parity: in f32, VGG's max-pool windows route a gradient
# by which of near-equal inputs is largest, and 13 convolutions summed in
# another order on the card flip more of them than the CPU copy's own
# 2**-22 spread does (one tensor at 6x it, the median at 2x): the f32
# step is held by its loss and its median error.  The same step in
# float64 activations flips none, and every gradient is held to 1e-6 of
# its scale (f64 sums in another order, each gradient rounded once to
# the f32 parameter's dtype: 6e-8); a wrong gradient path moves a tensor
# by O(1).  Faster R-CNN's head step holds the same way: its f32 step
# sits at the CPU copy's own 2**-22 spread (batch-1 BatchNorm's
# cancelling sums), and in float64 activations BatchNorm takes float64
# arithmetic too (`ops.nn._bn_acc`)
F64_GRAD_TOL = 1e-6
# MultiBoxDetection over the trained batch, its defaults: score 0.01, IoU
# 0.5, class-aware, every rank
SSD_NMS = 0.5
# bench.py config 3b: faster_rcnn_resnet50_v1b(classes=20), batch 2,
# 600 x 800 bf16 images, im_info [600, 800, 1], two gt boxes per image,
# 128 sampled rois per image, SGD lr 1e-3 momentum 0.9, hybridized
RCNN_BATCH = 2
RCNN_HW = (600, 800)
RCNN_ROIS = 128
# the staged parity at batch 1 samples 32 rois (8 foreground), so that
# the CPU copy's stage 4 over them takes seconds, not minutes
RCNN_PARITY_ROIS = 32
RCNN_SITES = 33         # 27 fused pairs in stages 1-3, 6 in stage 4
# the parity of a detection stage (RPN outputs, the head's loss and every
# gradient) on the card against a CPU copy, f32 without TF32: each tensor
# within TRAIN_TOL of its scale (floored at 1e-3 of the largest), as
# train's gradients


def _nms_inputs(torch, rs, B, N, scale, aware=False, ties=False):
    """B x N boxes in descending score order on the card, their valid
    flags (scores > 0) and, where `aware`, class ids of 20 classes."""
    ctr = rs.rand(B, N, 2) * scale
    wh = rs.rand(B, N, 2) * scale * 0.25 + scale / 100
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
    scores = np.sort(rs.uniform(-0.1, 1.0, (B, N)), axis=1)[:, ::-1]
    if ties:            # every third box repeats the box before it
        rep = boxes[:, 1::3].shape[1]
        boxes[:, 1::3] = boxes[:, 0:-1:3][:, :rep]
    dev = "cuda:0"
    return dict(
        boxes=torch.tensor(boxes, dtype=torch.float32, device=dev),
        valid=torch.tensor(scores > 0, device=dev),
        cls=torch.tensor(rs.randint(0, 20, (B, N)).astype(np.float32),
                         device=dev) if aware else None)


def _nms_taking_part(inp, upto=None):
    """(B, N) bool numpy: the boxes that take part in the greedy pass (its
    valid flags, every box without them); with `upto` (per image) of an
    image's first `upto[b]` boxes only."""
    valid = inp["valid"]
    valid = np.ones(inp["boxes"].shape[:2], bool) if valid is None \
        else valid.cpu().numpy().copy()
    if upto is not None:
        for b, u in enumerate(upto):
            valid[b, u:] = False
    return valid


def _nms_pairs(inp, part):
    """Pairs (i < j) whose IoU the greedy pass needs: of the boxes that
    take part (`part`), of one class where the pass is class-aware."""
    cls = None if inp["cls"] is None else inp["cls"].cpu().numpy()
    n = 0
    for b in range(part.shape[0]):
        if cls is None:
            k = int(part[b].sum())
            n += k * (k - 1) // 2
        else:
            c = np.bincount(cls[b][part[b]].astype(np.int64))
            n += int((c * (c - 1) // 2).sum())
    return n


def _nms_bound(inp, topk, keep_out=True, upto=None):
    """Least time (ms) of one NMS call: the pairs' IoUs on the CUDA cores
    (`_nms_pairs`), or the bytes it must move, the larger: every flag read
    and every keep flag written (unless positions only), the boxes and
    class ids of the boxes that take part (`_nms_taking_part`) read, and
    the kept positions written."""
    B, N = inp["boxes"].shape[:2]
    part = _nms_taking_part(inp, upto)
    nbytes = (B * N * ((inp["valid"] is not None) + keep_out)
              + int(part.sum()) * (16 + 4 * (inp["cls"] is not None))
              + B * topk * 8)
    pairs = _nms_pairs(inp, part)
    t_ops = pairs * NMS_PAIR_OPS / PEAK_FLOPS_F32_CUDA_CORES
    t_bytes = nbytes / PEAK_BYTES_S
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                pairs=pairs, bytes=nbytes)


def _nms_scratch_bytes(B, N):
    from incubator_mxnet_tpu_torch.ops import _kernels
    return B * _kernels.library("nms").mxt_nms_mask_words(N) * 8


def _nms_case(torch, nms, name, inp, thresh, plus_one, topk, timed,
              positions_only=False, prefix=None):
    """The kernel against its plain version on `inp`; with `timed` their
    times (CUDA events, median of 5 x 20), each launch's device time
    (profiler) and the bound.  With `prefix` the plain version runs on
    each image's first `prefix` boxes, which hold every box that takes
    part, and the kernel's keep flags past them must be False."""
    kw = dict(plus_one=plus_one, topk=topk, positions_only=positions_only)
    ref_inp = inp if prefix is None else {
        k: None if v is None else v[:, :prefix] for k, v in inp.items()}

    def run():
        return nms.nms_sorted(inp["boxes"], inp["valid"], thresh,
                              cls=inp["cls"], **kw)

    def plain():
        return nms.nms_sorted_plain(ref_inp["boxes"], ref_inp["valid"],
                                    thresh, cls=ref_inp["cls"], **kw)
    before = nms.nms_launches
    got = run()
    torch.cuda.synchronize()
    launched = nms.nms_launches - before
    ref = plain()
    # (keep or None, idx or None) of each
    got, ref = ((None, g) if positions_only else (g[0], g[1]) if topk > 0
                else (g, None) for g in (got, ref))
    B, N = inp["boxes"].shape[:2]
    keep, tail_false = got[0], True
    if keep is not None and prefix is not None:
        tail_false = not bool(keep[:, prefix:].any())
        keep = keep[:, :prefix]
    err = 0 if keep is None else (keep.int() - ref[0].int()).abs().max().item()
    if got[1] is not None:
        err = max(err, (got[1] - ref[1]).abs().max().item())
    kept = int((got[1] >= 0).sum()) if positions_only else int(got[0].sum())
    valid = inp["valid"]
    row = dict(case=name, shape=[B, N], thresh=thresh, plus_one=plus_one,
               class_aware=inp["cls"] is not None, topk=topk,
               positions_only=positions_only, launches=launched, kept=kept,
               valid_per_image=None if valid is None
               else valid.sum(1).tolist(),
               plain_on_prefix=prefix, max_abs_err=float(err),
               keep_equal=keep is None or bool(torch.equal(keep, ref[0])),
               idx_equal=got[1] is None or bool(torch.equal(got[1], ref[1])),
               tail_false=tail_false,
               scratch_bytes=_nms_scratch_bytes(B, N))
    if timed:
        row["ms"] = _time_ms(torch, run)
        row["plain_ms"] = _time_ms(torch, plain)
        row["device_ms"], row["device_kernels"] = _device_ms(torch, run)
        # positions only: the pass needs the boxes up to the topk-th kept
        upto = None if not positions_only else [
            N if int(i[-1]) < 0 else int(i[-1]) + 1 for i in got[1]]
        row.update(_nms_bound(inp, max(topk, 0), not positions_only, upto),
                   library_ms=None)
    return row


@contextlib.contextmanager
def _plain_nms(nms):
    """The detection ops' NMS by its plain version on card tensors, the
    route the kernel is held against (never the port's own)."""
    kernel = nms.nms_sorted
    nms.nms_sorted = nms.nms_sorted_plain
    try:
        yield
    finally:
        nms.nms_sorted = kernel


def phase_kernel_nms(torch):
    """The NMS kernel against its plain version at Proposal's, box_nms's
    and MultiBoxDetection's shapes, with flags that are no prefix, in the
    positions-only mode and on tied scores, and box_nms end to end by
    both routes; returns the timed rows by case."""
    from incubator_mxnet_tpu_torch.ops import contrib, nms
    t0 = time.monotonic()
    rs = np.random.RandomState(0)
    B, N, thresh, topk = NMS_PROPOSAL
    prop = _nms_inputs(torch, rs, B, N, 800.0)
    prop["valid"] = None                # Proposal passes no flags
    rows = [_nms_case(torch, nms, "proposal", prop, thresh, True, topk,
                      True)]
    B, N, thresh = NMS_BOX
    box = _nms_inputs(torch, rs, B, N, 1.0, aware=True)
    rows.append(_nms_case(torch, nms, "box_nms", box, thresh, False, 0,
                          True))
    ties = _nms_inputs(torch, rs, 2, 1000, 300.0, ties=True)
    rows.append(_nms_case(torch, nms, "ties_plus_one", ties, 0.6, True,
                          400, False))
    rows.append(_nms_case(torch, nms, "ties_corner", ties, 0.6, False, 0,
                          False))
    # box_nms end to end (rank, gather, the pass, scatter back), tied
    # scores (16 values) so that the stable rank decides
    scores = torch.tensor(np.round(rs.uniform(-0.1, 1.0, (B, N)) * 16) / 16,
                          dtype=torch.float32, device="cuda:0")
    det = torch.cat([box["cls"][..., None], scores[..., None],
                     box["boxes"]], -1)
    got = contrib.box_nms(det, overlap_thresh=thresh, id_index=0)
    with _plain_nms(nms):
        ref = contrib.box_nms(det, overlap_thresh=thresh, id_index=0)
    e2e = bool(torch.equal(got, ref))
    B, N, thresh, share = NMS_MULTIBOX
    mbox = _nms_inputs(torch, rs, B, N, 1.0, aware=True)
    ends = np.round(N * rs.uniform(*share, B)).astype(np.int64)
    mbox["valid"] = torch.tensor(np.arange(N)[None, :] < ends[:, None],
                                 device="cuda:0")
    rows.append(_nms_case(torch, nms, "multibox_detection", mbox, thresh,
                          False, 0, True, prefix=int(ends.max())))
    B, N, thresh = NMS_INTERLEAVED
    inter = _nms_inputs(torch, rs, B, N, 800.0)
    flags = (np.arange(N) % 2 == 0)[None, :] | (rs.rand(B, N) < 0.33)
    inter["valid"] = torch.tensor(flags, device="cuda:0")
    rows.append(_nms_case(torch, nms, "interleaved_flags", inter, thresh,
                          False, 0, True))
    _, _, thresh, topk = NMS_PROPOSAL
    rows.append(_nms_case(torch, nms, "proposal_positions_only", prop,
                          thresh, True, topk, True, positions_only=True))
    _emit(dict(phase="kernel_nms", seconds=time.monotonic() - t0,
               cases=rows, box_nms_end_to_end_equal=e2e,
               library="none: torch has no NMS call and the card's "
                       "machine has no torchvision"))
    for r in rows:
        _check(r["keep_equal"] and r["idx_equal"] and r["tail_false"],
               "NMS kernel differs from its plain version: %r" % (r,))
        _check(r["launches"] == 1 and 0 < r["kept"] < r["shape"][0]
               * r["shape"][1], "NMS case %s launched %d times and kept "
               "%d" % (r["case"], r["launches"], r["kept"]))
    _check(e2e, "box_nms by the kernel differs from its plain route")
    return {r["case"]: r for r in rows if "ms" in r}


@contextlib.contextmanager
def _recorded_nms(nms):
    """The inputs of every `nms_sorted` call inside (the detection ops'
    own), each still run by the kernel: [{boxes, valid, cls}]."""
    calls, kernel = [], nms.nms_sorted

    def recording(boxes, valid, thresh, **kw):
        calls.append(dict(boxes=boxes, valid=valid, cls=kw.get("cls")))
        return kernel(boxes, valid, thresh, **kw)
    nms.nms_sorted = recording
    try:
        yield calls
    finally:
        nms.nms_sorted = kernel


def _nms_profiled(kernels):
    """The NMS kernel's launches by name among `_port_kernel_calls`'
    {port kernel: launches per call}."""
    return {k: n for k, n in kernels.items() if k.startswith("mxt_nms_")}


def _detection_invariants(torch, det, scores, thresh):
    """MultiBoxDetection's output (B, N, 6) against the greedy pass's two
    invariants, per image and class: no two kept boxes overlap above
    `thresh`, and every valid box not kept overlaps a kept box of its
    class that scores at least as high (`scores`: the boxes' scores
    before the pass).  The IoUs are `ops.nms.iou_corner`'s on the card,
    another computation than the kernel's, so each test leaves 1e-6 at
    the threshold."""
    from incubator_mxnet_tpu_torch.ops import nms
    worst, unexplained, kept, suppressed = 0.0, 0, 0, 0
    for b in range(det.shape[0]):
        d, s = det[b], scores[b]
        cls, keep = d[:, 0], d[:, 1] >= 0
        for c in torch.unique(cls[cls >= 0]).tolist():
            k = (cls == c) & keep
            lost = (cls == c) & ~keep
            kb, ks = d[k, 2:], s[k]
            kept += kb.shape[0]
            suppressed += int(lost.sum())
            if kb.shape[0] > 1:
                iou = nms.iou_corner(kb, kb)
                iou.fill_diagonal_(0)
                worst = max(worst, iou.max().item())
            if bool(lost.any()):
                iou = nms.iou_corner(d[lost, 2:], kb)
                ok = (iou > thresh - 1e-6) & (ks[None, :] >= s[lost][:, None])
                unexplained += int((~ok.any(1)).sum())
    return dict(kept=kept, suppressed=suppressed,
                worst_kept_pair_iou_same_class=worst,
                suppressed_without_a_kept_suppressor=unexplained)


def _staged_err(torch, got, ref):
    """_scaled_err over two {name: tensor} of one stage."""
    return _scaled_err({n: t.detach().float().cpu() for n, t in got.items()},
                       {n: t.detach().float() for n, t in ref.items()})


def _spread_parity(torch, grads, ref_grads, spread_grads):
    """The card's gradients against a CPU copy's, beside the CPU copy's
    own spread (its gradients with the input scaled by 1 + 2**-22): the
    largest and the median error over scale (`_scaled_err`) of each."""
    err = _staged_err(torch, grads, ref_grads)
    spread = _staged_err(torch, spread_grads, ref_grads)
    worst = max(err, key=err.get)
    return dict(gradients=len(err), worst_grad=worst,
                grad_err_over_scale_max=dict(card=err[worst],
                                             cpu_spread=max(spread.values())),
                grad_err_over_scale_median=dict(
                    card=statistics.median(err.values()),
                    cpu_spread=statistics.median(spread.values())),
                within_train_tol=sum(v <= TRAIN_TOL for v in err.values()),
                spread_factor=RESNET_SPREAD_FACTOR)


def _spread_checks(name, parity, which=("max", "median")):
    """train_resnet's rule: max-pool windows and batch-1 BatchNorm's
    cancelling sums make these gradients no smooth function of the input
    at f32 rounding, so the card's largest and median errors are held to
    RESNET_SPREAD_FACTOR x the CPU copy's own under a 2**-22 change of
    its input; a wrong gradient path moves its tensors by O(1) of their
    scale."""
    for what in which:
        v = parity["grad_err_over_scale_" + what]
        _check(v["card"] <= RESNET_SPREAD_FACTOR * max(v["cpu_spread"],
                                                       1e-6),
               "%s: the %s gradient error against the CPU copy, %g of its "
               "scale, exceeds %g x the CPU copy's own spread %g"
               % (name, what, v["card"], RESNET_SPREAD_FACTOR,
                  v["cpu_spread"]))


def _det_train_checks(name, run, conv_want, nms_want):
    """A detection training run's gates (`run`: what `_mode_run`
    returns): finite losses; the eager warm-up step and the capturing one
    issued a step's kernels; the timed steps only replayed and ran no
    wrapper; a profiled (replayed) step launched the kernels by name."""
    out, _, (per_step, warmup) = run
    _check(all(math.isfinite(v) for v in out["losses"]),
           "%s: non-finite loss %r" % (name, out["losses"]))
    want = (0,) * len(_COUNT_KEYS) + (conv_want, nms_want)
    zero = (0,) * len(want)
    for launched, programs in warmup:
        # a step that ran the blocks eagerly or captured them launched a
        # step's kernels; one that replayed them launched none
        ran = programs["eager_calls"] or programs["captures"] \
            and not programs["replays"]
        _check(launched == (want if ran else zero), "%s: a warm-up step "
               "launched %r, not %r" % (name, launched,
                                        want if ran else zero))
    _check(warmup[1][1]["captures"] > 0,
           "%s: the second warm-up step captured nothing" % name)
    _check(all(c == zero for c in per_step),
           "%s: a timed step ran a kernel wrapper: %r"
           % (name, sorted(set(per_step))))
    timed = out["programs"]["during_timed_steps"]
    _check(timed["captures"] == 0 and timed["eager_updates"] == 0
           and timed["eager_calls"] == 0 and timed["replays"] > 0,
           "%s: the timed steps did not only replay: %r" % (name, timed))
    conv = out["profiled_launches_per_step"]["conv"]
    _check(conv == conv_want, "%s: a profiled step launched the conv "
           "kernel %d times, not %d" % (name, conv, conv_want))
    nms_names = {"mxt_nms_mask_kernel": nms_want,
                 "mxt_nms_scan_kernel": nms_want} if nms_want else {}
    got = _nms_profiled(out["profile"]["port_kernels"])
    _check(got == nms_names, "%s: a profiled step launched %r of the NMS "
           "kernel, not %r" % (name, got, nms_names))


def _det_summary(out):
    return _summary(out) | dict(images_per_s=out["units_per_s"])


def _ssd_loss_grads(mx, net, loss_b, x, y):
    with mx.autograd.record():
        loss = loss_b(*net(x), y)
    mx.autograd.backward(loss)
    return loss.detach(), {n: p.grad.detach().clone()
                           for n, p in net.collect_params().items()
                           if p.requires_grad}


def _carry(mx, net, cpu_net):
    """`cpu_net` given `net`'s parameters (materialised on the card) by
    structural name."""
    mx.weights.load_reference_params(
        cpu_net, {n: p.detach().float().cpu().numpy()
                  for n, p in net.collect_params().items()}, device="cpu")


def phase_train_ssd(torch, mx, att, cs):
    """SSD-512 on VGG16-reduced-atrous as bench.py's run_ssd trains it,
    then MultiBoxDetection over the trained batch; returns the NMS
    kernel's launches and the run's summary."""
    from incubator_mxnet_tpu_torch.models import ssd_512_vgg16, SSDTrainLoss
    from incubator_mxnet_tpu_torch.ops import contrib, nms
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    rs = np.random.RandomState(0)
    images = rs.randn(SSD_BATCH, 3, SSD_SIZE, SSD_SIZE).astype(np.float32)
    labels = np.zeros((SSD_BATCH, 1, 5), np.float32)
    labels[:, 0] = [1, 0.2, 0.2, 0.7, 0.7]
    mx.random.seed(0)
    net = ssd_512_vgg16(classes=SSD_CLASSES)
    net.initialize(ctx="cuda:0")
    loss_b = SSDTrainLoss()
    # parity: one batch-1 f32 step against a CPU copy at the same 512 x
    # 512 (VGG16-reduced needs at least 264 px for conv12's 1 x 1 map)
    x1 = torch.from_numpy(images[:1])
    y1 = torch.from_numpy(labels[:1])
    with mx.autograd.pause():
        net(x1.cuda())
    cpu_net = ssd_512_vgg16(classes=SSD_CLASSES)
    _carry(mx, net, cpu_net)
    loss1, grads = _ssd_loss_grads(mx, net, loss_b, x1.cuda(), y1.cuda())
    cpu_loss = SSDTrainLoss()
    ref_loss, ref_grads = _ssd_loss_grads(mx, cpu_net, cpu_loss, x1, y1)
    _, spread_grads = _ssd_loss_grads(mx, cpu_net, cpu_loss,
                                      x1 * (1.0 + 2.0 ** -22), y1)
    parity = _spread_parity(torch, grads, ref_grads, spread_grads)
    loss_err = abs(loss1.item() - ref_loss.item())
    parity.update(batch=1, dtype="float32", image=[3, SSD_SIZE, SSD_SIZE],
                  loss=loss1.item(), loss_abs_err=loss_err)
    # the same step in float64 activations (the f32 weights cast up by
    # every layer): no max-pool window flips, every gradient path held
    _, grads = _ssd_loss_grads(mx, net, loss_b, x1.double().cuda(),
                               y1.cuda())
    _, ref_grads = _ssd_loss_grads(mx, cpu_net, cpu_loss, x1.double(), y1)
    err64 = _staged_err(torch, grads, ref_grads)
    worst64 = max(err64, key=err64.get)
    parity.update(float64=dict(worst_grad=worst64,
                               worst_grad_err_over_scale=err64[worst64],
                               gradients=len(err64), tol=F64_GRAD_TOL))
    del cpu_net, ref_grads, grads, spread_grads
    x = torch.from_numpy(images).cuda().to(torch.bfloat16)
    y = torch.from_numpy(labels).cuda()

    def step(net, loss_b, trainer):
        with mx.autograd.record():
            anchors, cls_preds, box_preds = net(x)
            loss = loss_b(anchors, cls_preds, box_preds, y)
        mx.autograd.backward(loss)
        trainer.step(SSD_BATCH)
        return loss.detach()
    # the main path starts and ends its counts in _mode_run; the detection
    # after it adds its own launch
    run = _mode_run(torch, mx, att, cs, lambda: (
        net, loss_b, mx.gluon.Trainer(net.collect_params(), "sgd", {
            "learning_rate": 0.01, "momentum": 0.9})), step, True, SSD_BATCH)

    # detection over the trained batch: its softmaxed class scores
    with mx.autograd.pause():
        anchors, cls_preds, box_preds = net(x)
    cls_prob = torch.softmax(cls_preds.float(), -1).transpose(1, 2)
    loc = box_preds.float()
    before = nms.nms_launches
    with _recorded_nms(nms) as calls:
        det = contrib.multibox_detection(cls_prob, loc, anchors,
                                         nms_threshold=SSD_NMS)
    torch.cuda.synchronize()
    det_launches = nms.nms_launches - before
    # its NMS: the ranked boxes, the flags of those over the 0.01 score,
    # their classes; the bound counts the same-class pairs of those boxes
    det_in = calls[0]
    det_valid = det_in["valid"]
    det_nms = dict(
        valid_per_image=det_valid.sum(1).tolist(),
        n_eff_per_image=[int(v.nonzero().max()) + 1 if bool(v.any()) else 0
                         for v in det_valid],
        scratch_bytes=_nms_scratch_bytes(*det_valid.shape),
        **_nms_bound(det_in, 0))
    launches = nms.nms_launches         # the main path ends here
    inv = _detection_invariants(torch, det, cls_prob[:, 1:].amax(1),
                                SSD_NMS)
    det_ms = _time_ms(torch, lambda: contrib.multibox_detection(
        cls_prob, loc, anchors, nms_threshold=SSD_NMS), reps=5, rounds=3)
    det_rows, _ = _device_kernels(
        torch, lambda: contrib.multibox_detection(
            cls_prob, loc, anchors, nms_threshold=SSD_NMS), 1)
    det_kernels = dict(
        nms_launches=_nms_profiled(_port_kernel_calls(det_rows)),
        nms_device_us={k[:60]: us for us, k, _ in det_rows
                       if "mxt_nms_" in k},
        device_us=sum(r[0] for r in det_rows))
    _emit(dict(phase="train_ssd", model="ssd_512_vgg16",
               classes=SSD_CLASSES, dtype="bfloat16", batch=SSD_BATCH,
               image=[3, SSD_SIZE, SSD_SIZE], optimizer="sgd", lr=0.01,
               momentum=0.9, anchors=int(anchors.shape[1]),
               seconds=time.monotonic() - t0, parity=parity, **run[0],
               images_per_s=run[0]["units_per_s"],
               detection=dict(shape=list(det.shape), nms_threshold=SSD_NMS,
                              launches=det_launches, ms=det_ms, nms=det_nms,
                              **inv, **det_kernels)))
    _check(anchors.shape[1] == SSD_ANCHORS, "%d anchors, not %d"
           % (anchors.shape[1], SSD_ANCHORS))
    _check(loss_err <= SERVE_TOL * max(1.0, abs(ref_loss.item())),
           "the batch-1 loss differs from the CPU copy by %g" % loss_err)
    _spread_checks("train_ssd", parity, ("median",))
    _check(err64[worst64] <= F64_GRAD_TOL and len(err64) == 79,
           "float64 gradient %s differs from the CPU copy by %g of its "
           "scale > %g (%d tensors)" % (worst64, err64[worst64], F64_GRAD_TOL,
                                        len(err64)))
    _check(parity["gradients"] == 79, "%d trainable tensors, not 79"
           % parity["gradients"])
    _det_train_checks("train_ssd", run, 0, 0)
    _check(len(calls) == 1 and det_launches == 1
           and det_kernels["nms_launches"] == {
               "mxt_nms_count_kernel": 1, "mxt_nms_mask_kernel": 1,
               "mxt_nms_scan_kernel": 1},
        "MultiBoxDetection launched the NMS kernel %d times (%r)"
        % (det_launches, det_kernels["nms_launches"]))
    _check(inv["kept"] > 0 and inv["suppressed"] > 0,
           "the detection kept %d and suppressed %d" % (inv["kept"],
                                                       inv["suppressed"]))
    _check(inv["worst_kept_pair_iou_same_class"] <= SSD_NMS + 1e-6,
           "two kept boxes of one class overlap at IoU %g"
           % inv["worst_kept_pair_iou_same_class"])
    _check(inv["suppressed_without_a_kept_suppressor"] == 0,
           "%d suppressed boxes overlap no kept box of their class that "
           "scores higher" % inv["suppressed_without_a_kept_suppressor"])
    return dict(launches=launches, detection_launches=det_launches,
                detection_ms=det_ms, detection_nms=det_nms,
                **_det_summary(run[0]))


def _rcnn_data(batch):
    rs = np.random.RandomState(0)
    H, W = RCNN_HW
    x = rs.randn(batch, 3, H, W).astype(np.float32)
    im_info = np.tile([H, W, 1.0], (batch, 1)).astype(np.float32)
    gt = np.zeros((batch, 2, 5), np.float32)
    gt[:, 0] = [60, 60, 260, 260, 1]
    gt[:, 1] = [200, 200, 420, 420, 2]
    return x, im_info, gt


def _rcnn_head_grads(mx, net, loss_b, x, sel):
    """The head's loss and every gradient it reaches, on the sampled
    rois `sel` = (rois, labels, targets, weights)."""
    rois, labels, targets, weights = sel
    with mx.autograd.record():
        feat = net.features(x)
        cls_pred, box_pred = net.head(feat, rois)
        loss = loss_b(cls_pred, box_pred, labels, targets, weights)
    mx.autograd.backward(loss)
    return loss.detach(), {n: p.grad.detach().clone()
                           for n, p in net.collect_params().items()
                           if p.requires_grad and p.grad is not None}


@contextlib.contextmanager
def _conv_sites(cs):
    """{(C, HW, O): launches} of the conv kernel inside."""
    seen, launch = collections.Counter(), cs._fused_cuda

    def counted(x, w):
        seen[(x.shape[1], x.shape[2], w.shape[0])] += 1
        return launch(x, w)
    cs._fused_cuda = counted
    try:
        yield seen
    finally:
        cs._fused_cuda = launch


def _rcnn_parity(torch, mx, cs, net, loss_b, nms, rcnn):
    """The staged parity at batch 1, f32: the RPN's outputs against a CPU
    copy; Proposal and ProposalTarget on the card's RPN outputs by the
    kernel and by the plain route, exactly; the head's loss and every
    gradient against the CPU copy fed the card's sampled rois, with the
    conv kernel's launch sites of that step (`rcnn_conv_shapes`); and the
    same step in float64 activations, every gradient within
    F64_GRAD_TOL."""
    from incubator_mxnet_tpu_torch.models import (faster_rcnn_resnet50_v1b,
                                                  RCNNTrainLoss)
    x, im_info, gt = (torch.from_numpy(a) for a in _rcnn_data(1))
    xc, ic, gc_ = x.cuda(), im_info.cuda(), gt.cuda()
    with mx.autograd.pause():
        net(xc, ic)                     # every deferred width
    cpu = faster_rcnn_resnet50_v1b(classes=SSD_CLASSES)
    _carry(mx, net, cpu)
    rpn, ref_rpn = {}, {}
    for model, inp, out in ((net, xc, rpn), (cpu, x, ref_rpn)):
        with mx.autograd.record():      # batch statistics, as in a step
            out["rpn_cls"], out["rpn_box"] = model.rpn(model.features(inp))
    rpn_err = _staged_err(torch, rpn, ref_rpn)

    def select():
        with torch.no_grad():
            rois = net.proposals(rpn["rpn_cls"], rpn["rpn_box"], ic)
            return (rois,) + tuple(rcnn.proposal_target(
                rois, gc_, num_classes=SSD_CLASSES + 1, batch_images=1,
                batch_rois=RCNN_PARITY_ROIS))
    kernel_sel = select()
    with _plain_nms(nms):
        plain_sel = select()
    names = ("proposals", "rois", "labels", "targets", "weights")
    sel_equal = {n: bool(torch.equal(a, b))
                 for n, a, b in zip(names, kernel_sel, plain_sel)}
    sampled = kernel_sel[1:]
    with _conv_sites(cs) as sites:
        loss, grads = _rcnn_head_grads(mx, net, loss_b, xc, sampled)
    cpu_sel = tuple(t.cpu() for t in sampled)
    cpu_loss = RCNNTrainLoss()
    ref_loss, ref_grads = _rcnn_head_grads(mx, cpu, cpu_loss, x, cpu_sel)
    _, spread_grads = _rcnn_head_grads(mx, cpu, cpu_loss,
                                       x * (1.0 + 2.0 ** -22), cpu_sel)
    parity = _spread_parity(torch, grads, ref_grads, spread_grads)
    # the same step in float64 activations (F64_GRAD_TOL's comment)
    _, g64 = _rcnn_head_grads(mx, net, loss_b, xc.double(), sampled)
    _, ref64 = _rcnn_head_grads(mx, cpu, cpu_loss, x.double(), cpu_sel)
    err64 = _staged_err(torch, g64, ref64)
    worst64 = max(err64, key=err64.get)
    parity.update(
        batch=1, dtype="float32", image=[3] + list(RCNN_HW),
        rpn_err_over_scale=rpn_err, selection_equal=sel_equal,
        proposals_kept=int((kernel_sel[0][:, 1] >= 0).sum()),
        sampled_rois=RCNN_PARITY_ROIS,
        foreground=int((sampled[1] > 0).sum()),
        loss=loss.item(), loss_abs_err=abs(loss.item() - ref_loss.item()),
        cpu_gradients=len(ref_grads),
        conv_sites={"%d,%d,%d" % k: n for k, n in sorted(sites.items())},
        float64=dict(worst_grad=worst64,
                     worst_grad_err_over_scale=err64[worst64],
                     gradients=len(err64), tol=F64_GRAD_TOL))
    return parity


def phase_train_rcnn(torch, mx, att, cs):
    """Faster R-CNN on resnet50_v1b as bench.py's run_rcnn trains it;
    returns the conv and NMS kernels' launches and the run's summary."""
    from incubator_mxnet_tpu_torch.models import (faster_rcnn_resnet50_v1b,
                                                  RCNNTrainLoss)
    from incubator_mxnet_tpu_torch.ops import nms, rcnn
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    mx.random.seed(0)
    net = faster_rcnn_resnet50_v1b(classes=SSD_CLASSES)
    net.initialize(ctx="cuda:0")
    loss_b = RCNNTrainLoss()
    parity = _rcnn_parity(torch, mx, cs, net, loss_b, nms, rcnn)

    x, im_info, gt = _rcnn_data(RCNN_BATCH)
    x = torch.from_numpy(x).cuda().to(torch.bfloat16)
    im_info, gt = torch.from_numpy(im_info).cuda(), \
        torch.from_numpy(gt).cuda()

    def step(net, loss_b, trainer):
        with mx.autograd.record():
            (cls_pred, box_pred, rois, labels, targets, weights, _, _) = \
                net(x, im_info, gt_boxes=gt,
                    batch_rois=RCNN_ROIS * RCNN_BATCH)
            loss = loss_b(cls_pred, box_pred, labels, targets, weights)
        mx.autograd.backward(loss)
        # the head loss does not reach the RPN: its parameters take zero
        # gradients, as in the JAX Trainer
        trainer.step(RCNN_BATCH)
        return loss.detach()
    run = _mode_run(torch, mx, att, cs, lambda: (
        net, loss_b, mx.gluon.Trainer(net.collect_params(), "sgd", {
            "learning_rate": 1e-3, "momentum": 0.9})), step, True,
        RCNN_BATCH)
    out = run[0]
    launches = {k: out["launches"][k] for k in ("conv", "nms")}
    _emit(dict(phase="train_rcnn", model="faster_rcnn_resnet50_v1b",
               classes=SSD_CLASSES, dtype="bfloat16", batch=RCNN_BATCH,
               image=[3] + list(RCNN_HW), rois=RCNN_ROIS * RCNN_BATCH,
               optimizer="sgd", lr=1e-3, momentum=0.9,
               seconds=time.monotonic() - t0, parity=parity, **out,
               images_per_s=out["units_per_s"]))
    _check(max(parity["rpn_err_over_scale"].values()) <= TRAIN_TOL,
           "the RPN's outputs differ from the CPU copy: %r"
           % parity["rpn_err_over_scale"])
    _check(all(parity["selection_equal"].values()),
           "Proposal/ProposalTarget by the kernel differ from the plain "
           "route: %r" % parity["selection_equal"])
    _check(parity["foreground"] > 0, "no foreground roi was sampled")
    _check(parity["loss_abs_err"] <= SERVE_TOL * max(1.0, parity["loss"]),
           "the head's loss differs from the CPU copy: %r" % parity)
    _spread_checks("train_rcnn", parity)
    _check(parity["gradients"] == parity["cpu_gradients"] > 0,
           "the card reached %d gradients, the CPU copy %d"
           % (parity["gradients"], parity["cpu_gradients"]))
    f64 = parity["float64"]
    _check(f64["worst_grad_err_over_scale"] <= F64_GRAD_TOL
           and f64["gradients"] == parity["cpu_gradients"],
           "float64 gradient %s differs from the CPU copy by %g of its "
           "scale > %g (%d tensors)" % (f64["worst_grad"],
                                        f64["worst_grad_err_over_scale"],
                                        F64_GRAD_TOL, f64["gradients"]))
    want_sites = {"%d,%d,%d" % (C, HW, O): k
                  for _, C, HW, O, k in rcnn_conv_shapes(cs)}
    _check(parity["conv_sites"] == want_sites,
           "the head step launched the conv kernel at %r, not at "
           "rcnn_conv_shapes' %r" % (parity["conv_sites"], want_sites))
    _det_train_checks("train_rcnn", run, RCNN_SITES, 1)
    _check(launches == dict(conv=2 * RCNN_SITES, nms=2),
           "the warm-up steps launched %r (a step is %d conv and 1 NMS)"
           % (launches, RCNN_SITES))
    return dict(launches=launches, **_det_summary(out),
                profiled_conv_per_step=out["profiled_launches_per_step"][
                    "conv"],
                profiled_nms_per_step=_nms_profiled(
                    out["profile"]["port_kernels"]))


# -- the Gluon layers and the vision model zoo ------------------------------

MOBILENET_SITES = 34    # pointwise conv + BN pairs of mobilenet_v2_1_0
# GluonCV's mobilenetv2_1.0 ImageNet recipe
# (scripts/classification/imagenet/train_imagenet.py) decays with wd
# 4e-5; lr and momentum stay the Gluon loop's
MOBILENET_NAG = dict(GLUON_NAG, wd=4e-5)
# the other families, at their published widths and input sides: one
# hybridized bf16 step at batch ZOO_BATCH, then a replayed one
ZOO = (("resnet50_v2", 224), ("vgg16_bn", 224), ("alexnet", 224),
       ("densenet121", 224), ("squeezenet1_1", 224), ("mobilenet1_0", 224),
       ("mobilenet_v3_large", 224), ("inception_v3", 299))
ZOO_BATCH = 8
ZOO_SGD = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
# f32 logits of a batch-2 inference forward against the CPU copy, as the
# served logits are held: the same f32 network, cuDNN's and the CPU's
# convolution sums in other orders (TF32 off)
ZOO_TOL = SERVE_TOL
# the layers phase: f32 outputs and gradients, card against a CPU copy,
# each within LAYER_TOL of its scale (at least 1)
LAYER_TOL = 1e-4


def _spy(module, name, record):
    """Wrap module.name so that each call first hands its arguments to
    `record`; returns a function that restores it."""
    orig = getattr(module, name)

    def spied(*args, **kwargs):
        record(*args, **kwargs)
        return orig(*args, **kwargs)
    setattr(module, name, spied)
    return lambda: setattr(module, name, orig)


def _mobilenet_parity(torch, mx):
    """mobilenet_v2_1_0 (f32, widths deferred, MSRAPrelu on the card)
    through one batch-2 training step against a CPU copy, as
    train_resnet holds resnet50_v1b: the loss within SERVE_TOL, the
    gradients by `_spread_parity` (held by `_spread_checks`), the running
    statistics within RUNNING_TOL.  The card's forward also names the
    step's pointwise sites, each (C, HW, O) with its count."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    from incubator_mxnet_tpu_torch.ops import nn as ops_nn
    mx.random.seed(0)
    net = get_model("mobilenet_v2_1_0", classes=1000)
    net.initialize(mx.init.MSRAPrelu(), ctx=mx.gpu(0))
    cpu = get_model("mobilenet_v2_1_0", classes=1000)
    cpu.initialize(ctx="cpu")
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(RESNET_PARITY_BATCH, 3, 224, 224)
                         .astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 1000, RESNET_PARITY_BATCH)
                         .astype(np.float32))
    _copy_to_cpu(mx, net, cpu, x[:1])
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    pointwise = collections.Counter()
    undo = _spy(ops_nn, "conv1x1_bn_stats", lambda data, weight: pointwise.
                update([(data.shape[1], data.shape[2] * data.shape[3],
                         weight.shape[0])]))
    try:
        loss, grads, running = _resnet_grads(mx, net, loss_fn, x.cuda(),
                                             y.cuda())
    finally:
        undo()
    ref_loss, ref_grads, ref_running = _resnet_grads(mx, cpu, loss_fn, x, y)
    _, spread_grads, _ = _resnet_grads(mx, cpu, loss_fn,
                                       x * (1.0 + 2.0 ** -22), y)
    row = dict(batch=RESNET_PARITY_BATCH, dtype="float32",
               loss_max_abs_err=(loss - ref_loss).abs().max().item(),
               loss_tol=SERVE_TOL,
               **_spread_parity(torch, grads, ref_grads, spread_grads),
               worst_running_err_over_scale=max(
                   _scaled_err(running, ref_running).values()),
               running_tol=RUNNING_TOL)
    del net, cpu
    return row, pointwise


def phase_train_mobilenet(torch, mx, att, cs):
    """mobilenet_v2_1_0 (1000 classes) trained as train_resnet_gluon
    trains resnet50_v1b: get_model with the widths deferred,
    initialize(MSRAPrelu, ctx=gpu(0)), batch 128 x 3 x 224 x 224 bf16
    from RandomState(0), NAG (MOBILENET_NAG) under the warmup-cosine
    schedule, no wd on beta, gamma and bias, hybridized; eager and
    hybridized from the same weights and data through `phase_hybridize`
    (bit for bit, 34 conv launches a step by the counters and by the
    profiler's kernel names, the timed steps only replaying).  Before
    it, one f32 batch-2 step against the CPU copy (`_mobilenet_parity`),
    whose forward's pointwise sites must be `cs.MOBILENET_V2_CONV_SHAPES`;
    from the hybridized step's profile, the depthwise convolutions'
    device time (torch's conv_depthwise2d kernels) and share of the
    step.  Returns the hybridized run."""
    t0 = time.monotonic()
    parity, pointwise = _mobilenet_parity(torch, mx)
    want = {(C, HW, O): k for C, HW, O, k in cs.MOBILENET_V2_CONV_SHAPES}
    gc.collect()
    torch.cuda.empty_cache()
    img, ilab = _resnet_batch(torch)
    run = phase_hybridize(
        torch, mx, att, cs, "train_mobilenet",
        _gluon_build(mx, "mobilenet_v2_1_0", MOBILENET_NAG),
        lambda n, h, t: _gluon_step(mx, n, t, h, img, ilab)[1],
        RESNET_BATCH, (0,) * 6 + (MOBILENET_SITES, 0))
    dw_ms = run["profile"]["depthwise_us_per_step"] / 1e3
    conv_us = {k: us for k, us in run["profile"][
        "port_kernel_us_per_step"].items()
        if k.startswith("conv1x1") or k == "stats_reduce_kernel"}
    out = dict(phase="train_mobilenet", model="mobilenet_v2_1_0",
               classes=1000, dtype="bfloat16", batch=RESNET_BATCH,
               image=[3, 224, 224], init="MSRAPrelu", no_wd=GLUON_NO_WD,
               optimizer="nag", **MOBILENET_NAG,
               lr_scheduler=dict(GLUON_LR, kind="CosineScheduler",
                                 max_update=GLUON_MAX_UPDATE),
               nvidia_smi=_nvidia_smi(), **_summary(run),
               step_ms=run["step_ms"], losses=run["losses"],
               eager_vs_hybridized=run["compare"],
               conv_launches_per_replayed_step=run[
                   "profiled_launches_per_step"]["conv"],
               conv_device_ms_per_step=sum(conv_us.values()) / 1e3,
               conv_kernel_us_per_step=conv_us,
               pointwise_sites={"%d,%d,%d" % k: n
                                for k, n in sorted(pointwise.items())},
               pointwise_sites_match=dict(pointwise) == want,
               depthwise_device_ms_per_step=dw_ms,
               depthwise_share=dw_ms / run["step_ms_median"],
               depthwise_share_of_device=dw_ms * 1e3 * run["profile"][
                   "steps"] / run["profile"]["device_us"],
               parity=parity,
               wall_s=time.monotonic() - t0)
    _emit(out)
    cmp = run["compare"]
    _check(cmp["losses_bit_equal"] and cmp["params_bit_equal"],
           "train_mobilenet: eager and hybridized differ: %r" % (cmp,))
    _check(out["pointwise_sites_match"], "train_mobilenet: the net's "
           "pointwise sites %r are not MOBILENET_V2_CONV_SHAPES"
           % (out["pointwise_sites"],))
    _check(parity["loss_max_abs_err"] <= SERVE_TOL
           and parity["worst_running_err_over_scale"] <= RUNNING_TOL,
           "train_mobilenet: the f32 step's loss or running statistics "
           "differ from the CPU copy's: %r" % (parity,))
    _spread_checks("train_mobilenet", parity)
    return out


def _zoo_conv_checks(torch, cs, seen):
    """`conv_check` at each distinct site of a zoo step: `seen` maps
    (N, C, H, W, O) to the first (data, weight) that
    `ops.nn.conv1x1_bn_stats` was given there, as that op hands them to
    the kernel.  Returns the sites by instance, the largest errors over
    their bounds, and whether every site holds."""
    rows = []
    for (N, C, H, W, O), (data, weight) in sorted(seen.items()):
        rows.append(conv_check(torch, cs, data.reshape(N, C, H * W),
                               weight.reshape(O, C).to(data.dtype)))
    paths = collections.Counter(r["path"] for r in rows)
    return dict(sites=len(rows), paths=dict(paths),
                y_over_bound=max((max(r["y_over_bound"].values())
                                  for r in rows), default=0.0),
                rel_err_sums=max((max(r["rel_err_s1"], r["rel_err_s2"])
                                  for r in rows), default=0.0),
                tol_sums=CONV_SUM_TOL, ok=all(r["ok"] for r in rows),
                failed=[dict(N=N, C=C, HW=H * W, O=O, **r) for (
                    N, C, H, W, O), r in zip(sorted(seen), rows)
                    if not r["ok"]])


def phase_zoo(torch, mx, cs):
    """Each family of `ZOO` at its published width (1000 classes,
    MSRAPrelu on the card, hybridized with static_alloc and
    static_shape): a bf16 batch of ZOO_BATCH from RandomState(0) through
    an eager, a capturing and a replayed SGD step (ZOO_SGD), every loss
    finite; a fourth, profiled, replayed step launching the conv kernel
    as often as the block tree has fused pairs (`gluon.nn.fused_pairs`);
    the kernel against its plain version at each distinct pair of the
    eager step, on the inputs it had there (`_zoo_conv_checks`); then
    the f32 logits of a batch-2 inference forward against the CPU
    copy within ZOO_TOL of their scale.  Returns {family: launches}."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    from incubator_mxnet_tpu_torch.gluon.nn import fused_pairs
    from incubator_mxnet_tpu_torch.ops import nn as ops_nn
    t0 = time.monotonic()
    rows, launches = [], {}
    for name, side in ZOO:
        t1 = time.monotonic()
        mx.random.seed(0)
        net = get_model(name, classes=1000)
        net.initialize(mx.init.MSRAPrelu(), ctx=mx.gpu(0))
        net.hybridize(static_alloc=True, static_shape=True)
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   dict(ZOO_SGD))
        rs = np.random.RandomState(0)
        x = torch.from_numpy(rs.randn(ZOO_BATCH, 3, side, side).astype(
            np.float32)).cuda().to(torch.bfloat16)
        y = torch.from_numpy(rs.randint(0, 1000, ZOO_BATCH).astype(
            np.float32)).cuda()
        step = lambda: _train_step(mx, net, loss_fn, trainer, (x,), y)  # noqa
        pairs_seen = {}
        undo = _spy(ops_nn, "conv1x1_bn_stats",
                    lambda data, weight: pairs_seen.setdefault(
                        tuple(data.shape) + (weight.shape[0],),
                        (data.detach().clone(), weight.detach().clone())))
        try:
            losses = [step().mean().item()]     # eager: the wrappers run
        finally:
            undo()
        losses += [step().mean().item() for _ in range(2)]
        graph = net._cached_graph
        programs = dict(captures=graph.captures, replays=graph.replays,
                        trainer_captures=trainer.captures)
        kernel_rows, _ = _device_kernels(torch, step, 1)
        conv = _profiled_counts(_port_kernel_calls(kernel_rows))[3]
        pairs = fused_pairs(net)
        checks = _zoo_conv_checks(torch, cs, pairs_seen)
        del pairs_seen
        cpu = get_model(name, classes=1000)
        cpu.initialize(ctx="cpu")
        x2 = torch.from_numpy(rs.randn(2, 3, side, side).astype(np.float32))
        _copy_to_cpu(mx, net, cpu, x2[:1])
        with mx.autograd.pause():
            got = net(x2.cuda()).float().cpu()
            ref = cpu(x2)
        err = (got - ref).abs().max().item() / max(
            ref.abs().max().item(), 1e-30)
        row = dict(family=name, image=[3, side, side], batch=ZOO_BATCH,
                   losses=losses, programs=programs, fused_pairs=pairs,
                   conv_launches_replayed_step=conv, conv_checks=checks,
                   logits_err_over_scale=err, tol=ZOO_TOL,
                   seconds=time.monotonic() - t1)
        rows.append(row)
        launches[name] = conv
        del net, cpu, trainer, graph
        gc.collect()
        torch.cuda.empty_cache()
        _check(all(math.isfinite(v) for v in losses),
               "zoo %s: non-finite loss %r" % (name, losses))
        _check(programs["replays"] >= 1, "zoo %s: no replayed step: %r"
               % (name, programs))
        _check(conv == pairs, "zoo %s: the replayed step launched the conv "
               "kernel %d times, the block tree has %d fused pairs"
               % (name, conv, pairs))
        _check(checks["ok"], "zoo %s: conv1x1_stats disagrees with its "
               "plain version at a site of the step: %r" % (name, checks))
        _check(err <= ZOO_TOL, "zoo %s: logits differ from the CPU copy by "
               "%g of their scale" % (name, err))
    _emit(dict(phase="zoo", families=rows,
               wall_s=time.monotonic() - t0))
    return launches


def _layer_cases(mx):
    """(name, block, input shapes) of the layers phase: each new layer
    and container of gluon.nn and gluon.contrib.nn, small; fresh blocks
    at each call."""
    nn, cnn = mx.gluon.nn, mx.gluon.contrib.nn

    def seq(cls, *blocks):
        net = cls()
        net.add(*blocks)
        return net

    def concurrent():
        net = cnn.HybridConcurrent(axis=1)
        net.add(seq(nn.HybridSequential, nn.Conv2D(4, 1, use_bias=False),
                    nn.BatchNorm()),
                seq(nn.HybridSequential, nn.Conv2D(3, 1, use_bias=False),
                    nn.BatchNorm()), cnn.Identity())
        return net
    return [
        ("activations", seq(nn.HybridSequential, nn.LeakyReLU(0.1),
                            nn.PReLU(alpha_initializer="ones"), nn.ELU(),
                            nn.SELU(), nn.GELU(), nn.Swish()),
         [(4, 6, 5)]),
        ("conv1d", nn.Conv1D(8, 3, strides=2, padding=1, groups=2),
         [(4, 6, 20)]),
        ("conv3d", nn.Conv3D(4, 3, padding=1), [(2, 3, 6, 6, 6)]),
        ("conv_transposes", seq(nn.HybridSequential, nn.Conv2DTranspose(
            6, 3, strides=2, padding=1, output_padding=1),
            nn.GroupNorm(num_groups=3), nn.InstanceNorm(scale=True)),
         [(2, 4, 7, 7)]),
        ("conv1d_transpose", nn.Conv1DTranspose(3, 4, strides=3),
         [(2, 4, 9)]),
        ("conv3d_transpose", nn.Conv3DTranspose(2, 2, strides=2),
         [(2, 3, 3, 3, 3)]),
        ("pools", seq(nn.HybridSequential, nn.MaxPool3D(2),
                      nn.AvgPool3D(3, 1, 1, count_include_pad=False),
                      nn.GlobalAvgPool3D()), [(2, 3, 6, 6, 6)]),
        ("pools1d", seq(nn.HybridSequential, nn.MaxPool1D(3, 2, 1),
                        nn.AvgPool1D(2, ceil_mode=True),
                        nn.GlobalMaxPool1D()), [(2, 3, 15)]),
        ("reflection_pad", nn.ReflectionPad2D(2), [(2, 3, 6, 5)]),
        ("sequential_lambdas", seq(nn.Sequential, nn.Lambda("tanh"),
                                   nn.HybridLambda("relu"),
                                   nn.Dropout(0.3, axes=(1,))),
         [(4, 5, 6)]),
        ("hybrid_concurrent", concurrent(), [(2, 3, 8, 8)]),
        ("sync_batch_norm", cnn.SyncBatchNorm(), [(4, 3, 5, 5)]),
        ("pixel_shuffle1d", cnn.PixelShuffle1D(3), [(2, 6, 4)]),
        ("pixel_shuffle2d", cnn.PixelShuffle2D(2), [(2, 8, 3, 3)]),
        ("pixel_shuffle3d", cnn.PixelShuffle3D(2), [(1, 16, 2, 1, 3)]),
    ]


def phase_layers(torch, mx):
    """Each layer of `_layer_cases` and each new registry op of ops/nn.py
    forward and backward on the card (f32, TF32 off) against the same
    call on a CPU copy: outputs and every input and parameter gradient
    within LAYER_TOL of scale (Dropout at rate 0.3 shares one mask along
    axis 1 on the card, checked by its pattern, and runs at rate 0 in
    the comparison)."""
    t0 = time.monotonic()
    rs = np.random.RandomState(4)
    rows = []

    def compare(name, run, inputs):
        """run(tensors) -> (output, parameters) on each device."""
        worst = 0.0
        got = []
        for dev in ("cuda", "cpu"):
            ts = [torch.from_numpy(a).to(dev).requires_grad_()
                  for a in inputs]
            out, params = run(ts)
            cot = torch.from_numpy(np.random.RandomState(1).uniform(
                -1, 1, tuple(out.shape)).astype(np.float32)).to(dev)
            grads = torch.autograd.grad(out, ts + params, cot,
                                        allow_unused=True)
            got.append([out] + [g for g in grads if g is not None])
        for a, b in zip(*got):
            scale = max(1.0, b.abs().max().item())
            worst = max(worst, (a.cpu() - b).abs().max().item() / scale)
        rows.append(dict(name=name, err_over_scale=worst,
                         tensors=len(got[1])))
        _check(len(got[0]) == len(got[1]) and worst <= LAYER_TOL,
               "layers %s: the card differs from the CPU by %g of scale"
               % (name, worst))

    for (name, block, shapes), (_, card, _) in zip(_layer_cases(mx),
                                                   _layer_cases(mx)):
        inputs = [rs.uniform(-1, 1, s).astype(np.float32) for s in shapes]
        for net, dev in ((block, "cpu"), (card, "cuda")):
            for m in net.modules():
                if isinstance(m, mx.gluon.nn.Dropout) and m._rate:
                    with mx.autograd.record():
                        a = m(torch.ones(4, 50, 30, device=dev)).cpu()
                    _check(bool((a == a[:, :1]).all()),
                           "layers: Dropout(axes=(1,)) drew per element")
                    m._rate = 0.0
            net.initialize(mx.init.Xavier(), ctx=dev)
            with mx.autograd.pause():
                net(*[torch.from_numpy(a).to(dev) for a in inputs])
        card.load_state_dict(block.state_dict())
        nets = {"cuda": card, "cpu": block}

        def run(ts, name=name):
            net = nets[ts[0].device.type]
            with mx.autograd.record():
                out = net(*ts)
            return out, [p for p in net.parameters() if p.requires_grad]
        compare(name, run, inputs)

    ops = mx.ops.nn
    label = np.array([[1, 2, 2], [3, 0, 0]], np.float32)
    op_cases = [
        ("Deconvolution", lambda t: ops.deconvolution(
            t[0], t[1], t[2], stride=(2, 2), pad=(1, 1), adj=(1, 1),
            num_group=2, no_bias=False),
         [(2, 4, 5, 5), (4, 3, 3, 3), (6,)]),
        ("InstanceNorm", lambda t: ops.instance_norm(t[0], t[1], t[2]),
         [(2, 3, 4, 5), (3,), (3,)]),
        ("GroupNorm", lambda t: ops.group_norm(t[0], t[1], t[2],
                                               num_groups=2),
         [(2, 4, 3, 5), (4,), (4,)]),
        ("LRN", lambda t: ops.lrn(t[0], nsize=3), [(2, 6, 4, 4)]),
        ("UpSampling", lambda t: ops.upsampling(
            t[0], t[1], scale=2, num_args=2), [(2, 3, 4, 4), (2, 2, 2, 2)]),
        ("UpSampling_bilinear", lambda t: ops.upsampling(
            t[0], scale=3, sample_type="bilinear"), [(2, 3, 4, 5)]),
        ("GridGenerator", lambda t: ops.grid_generator(
            t[0], target_shape=(4, 5)), [(2, 6)]),
        ("GridGenerator_warp", lambda t: ops.grid_generator(
            t[0], transform_type="warp"), [(2, 2, 4, 5)]),
        ("CTCLoss", lambda t: ops.ctc_loss(
            t[0], torch.from_numpy(label).to(t[0].device)), [(6, 2, 5)]),
        ("SyncBatchNorm", lambda t: ops.sync_batch_norm(
            t[0], t[1], t[2], t[1].detach() * 0, t[1].detach() * 0 + 1,
            fix_gamma=False)[0], [(4, 3, 2, 2), (3,), (3,)]),
        ("softmax_use_length", lambda t: ops.softmax(
            t[0], length=None, use_length=True), [(3, 5)]),
    ]
    for name, fn, shapes in op_cases:
        inputs = [rs.uniform(-1, 1, s).astype(np.float32) for s in shapes]
        compare(name, lambda ts, fn=fn: (fn(ts), []), inputs)
    _emit(dict(phase="layers", cases=rows, tol=LAYER_TOL,
               wall_s=time.monotonic() - t0))


# -- slice 19: recurrent networks and GNMT ----------------------------------

# bench.py's config 4 (run_gnmt): gnmt_large, batch 128, source and target
# 50, vocab 32000, bf16, Adam lr 1e-3
GNMT_VOCAB = 32000
GNMT_UNITS = 1024
GNMT_BATCH = 128
GNMT_SEQ = 50
GNMT_LR = 1e-3
GNMT_PARITY_BATCH = 2
# the GNMT step's gradients are a smooth function of the weights, so the
# CPU copy's spread is its gradients with every weight nudged by
# 1 +- 2**-22 (random signs): a rounding-level change in every GEMM, as the
# card's other order of sums is.  The card's largest and median gradient
# errors are held to RESNET_SPREAD_FACTOR x that spread (`_spread_checks`);
# a wrong gate or a dropped freeze moves its layer's gradients by O(1)
GNMT_NUDGE = 2.0 ** -22
# bench.py's generation workload: build_generation_model's Seq2Seq (vocab
# 31, embed 24, hidden 32, 2 layers) behind run_generate's engine
S2S_VOCAB = 31
S2S_SLOTS = 4
S2S_MAX_LEN = 24
S2S_BUCKETS = (4, 8)
S2S_MAX_NEW = 12
S2S_PROMPT_LENGTHS = (3, 4, 5, 6, 7, 8)     # on a bucket: 4 and 8
S2S_TIMED_STEPS = 50
S2S_INIT_SIGMA = 0.5
# the rnn phase: every mode x {uni, bi} x {dense, varlen} through nd.RNN /
# nd.RNN_varlen, 2 layers, card against a CPU copy.  f32 outputs and
# gradients within RNN_TOL of scale (the same f32 sums in another order
# through 12 steps of 2 layers).  bf16 ones by the train_bf16 rule with
# train_resnet's spread in it (`rnn_bf16_over_rule`): each tensor's error
# against an f32 CPU run of the same bf16 values within BF16_ROUTE_FACTOR
# x the larger of the CPU's own bf16 error and that error at inputs
# nudged by one rounding (RNN_NUDGE), + one bf16 ulp
RNN_T, RNN_B, RNN_I, RNN_H, RNN_LAYERS = 12, 4, 16, 32, 2
RNN_LENGTHS = (12, 9, 5, 1)
RNN_TOL = 1e-4
RNN_NUDGE = 2.0 ** -8
# the yardstick: one GNMT encoder layer (T 50, B 128, 1024 -> 1024),
# forward + backward of the port's LSTM against torch.nn.LSTM (cuDNN) on
# the same weights; f32 outputs and gradients held to each other within
# RNN_TOL of scale, bf16 timed (CUDA events, median of YARD_REPS)
YARD_T, YARD_B, YARD_H = 50, 128, 1024
YARD_REPS = 10


def _gnmt_data(batch=GNMT_BATCH):
    """run_gnmt's src, tgt and labels, drawn in that order from
    RandomState(0) at batch 128; the first `batch` rows."""
    rs = np.random.RandomState(0)
    shape = (GNMT_BATCH, GNMT_SEQ)
    src = rs.randint(0, GNMT_VOCAB, shape).astype(np.int32)
    tgt = rs.randint(0, GNMT_VOCAB, shape).astype(np.int32)
    lab = rs.randint(0, GNMT_VOCAB, shape).astype(np.float32)
    return src[:batch], tgt[:batch], lab[:batch]


def gnmt_grads(mx, net, head, src, tgt, lab):
    """One recorded step of `net` + `head`: the loss and every gradient
    (f32, on the CPU) by structural name, the head's under "loss."."""
    with mx.autograd.record():
        loss = head(net(src, tgt), lab)
    mx.autograd.backward(loss)
    params = dict(net.collect_params())
    params.update({"loss." + n: p for n, p in head.collect_params().items()})
    return loss.detach().float().cpu(), {
        n: p.grad.detach().float().cpu().clone() for n, p in params.items()}


def nudge_weights(torch, blocks, rel, seed=1):
    """Scale every weight of `blocks` by 1 + rel or 1 - rel, the sign
    drawn per element from `seed`."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for blk in blocks:
            for p in blk.parameters():
                sign = torch.randint(0, 2, p.shape, generator=gen) * 2 - 1
                p.mul_(1 + rel * sign.to(p.device, p.dtype))


def _gnmt_parity(torch, mx):
    """gnmt_large (f32, output_hidden) + FusedMLMCELoss through one
    batch-2 step on the card against a CPU copy: the loss within
    SERVE_TOL, the gradients by `_spread_parity` against the CPU copy's
    spread under GNMT_NUDGE."""
    def build(device):
        return (mx.models.gnmt_large(output_hidden=True, device=device),
                mx.models.FusedMLMCELoss(GNMT_VOCAB, GNMT_UNITS,
                                         device=device))
    mx.random.seed(0)
    net, head = build("cuda:0")
    cpu_net, cpu_head = build("cpu")
    for a, b in ((net, cpu_net), (head, cpu_head)):
        b.load_state_dict({k: v.detach().cpu()
                           for k, v in a.state_dict().items()})
    data = [torch.from_numpy(a) for a in _gnmt_data(GNMT_PARITY_BATCH)]
    loss, grads = gnmt_grads(mx, net, head, *(t.cuda() for t in data))
    del net, head
    ref_loss, ref_grads = gnmt_grads(mx, cpu_net, cpu_head, *data)
    nudge_weights(torch, (cpu_net, cpu_head), GNMT_NUDGE)
    _, spread = gnmt_grads(mx, cpu_net, cpu_head, *data)
    return dict(parameters=sum(t.numel() for t in spread.values()),
                batch=GNMT_PARITY_BATCH, dtype="float32", nudge=GNMT_NUDGE,
                loss_max_abs_err=(loss - ref_loss).abs().max().item(),
                loss_tol=SERVE_TOL,
                **_spread_parity(torch, grads, ref_grads, spread))


def phase_train_gnmt(torch, mx, att, cs):
    """gnmt_large trained as bench.py's run_gnmt: output_hidden +
    FusedMLMCELoss(32000, 1024), both cast to bf16, Adam lr 1e-3, batch
    128 x 50 / 50 from RandomState(0); eager and hybridized (net
    static_alloc/static_shape) from the same weights and data through
    `phase_hybridize`: bit for bit, the timed steps only replaying, no
    port kernel launched (the recurrence, the attention and the fused CE
    are cuBLAS GEMMs and elementwise kernels).  Before it, one f32
    batch-2 step against a CPU copy (`_gnmt_parity`).  Prints step ms,
    target tokens/s, busy share, peak memory, the kernels a replayed step
    launches by the profiler's names and the costliest of them."""
    t0 = time.monotonic()
    parity = _gnmt_parity(torch, mx)
    gc.collect()
    torch.cuda.empty_cache()
    src, tgt, lab = (torch.from_numpy(a).cuda() for a in _gnmt_data())
    run = phase_hybridize(
        torch, mx, att, cs, "train_gnmt",
        _mlm_build(mx, lambda: mx.models.gnmt_large(output_hidden=True,
                                                    device="cuda:0"),
                   GNMT_VOCAB, GNMT_UNITS, "bfloat16",
                   optimizer_params={"learning_rate": GNMT_LR}),
        lambda n, h, t: _train_step(mx, n, h, t, (src, tgt), lab).mean(),
        GNMT_BATCH * GNMT_SEQ, (0,) * 8)
    out = dict(phase="train_gnmt", model="gnmt_large", vocab=GNMT_VOCAB,
               dtype="bfloat16", batch=GNMT_BATCH, src_len=GNMT_SEQ,
               tgt_len=GNMT_SEQ, optimizer="adam", learning_rate=GNMT_LR,
               parameters=parity.pop("parameters"),
               nvidia_smi=_nvidia_smi(), **_summary(run),
               target_tokens_per_s=run["units_per_s"],
               step_ms=run["step_ms"], losses=run["losses"],
               eager_vs_hybridized=run["compare"],
               kernels_per_replayed_step=run["profile"]["kernels_per_step"],
               top_kernels=run["profile"]["top"],
               captures_in_timed_steps=run["programs"][
                   "during_timed_steps"]["captures"],
               port_kernels="none of the five launches on this path",
               parity=parity, wall_s=time.monotonic() - t0)
    _emit(out)
    cmp = run["compare"]
    _check(cmp["losses_bit_equal"] and cmp["params_bit_equal"],
           "train_gnmt: eager and hybridized differ: %r" % (cmp,))
    _check(parity["loss_max_abs_err"] <= SERVE_TOL,
           "train_gnmt: the f32 step's loss differs from the CPU copy's: %r"
           % (parity,))
    _spread_checks("train_gnmt", parity)
    return out


def phase_generate_seq2seq(torch, mx, att, cs):
    """bench.py's generation workload: Seq2Seq (vocab 31, embed 24,
    hidden 32, 2 layers, seed 0) behind GenerationEngine with
    run_generate's settings (4 slots, max_len 24, prompt buckets 4 and 8,
    bos 1, eos 2): warmup's captures (buckets + 2), none in traffic; the
    tokens of prompts on and off a bucket against the port's eager greedy
    loop (`_greedy`, near-tie rule); the replayed decode step against the
    same function run eagerly (CUDA events, median of 50); no port kernel
    launched."""
    from incubator_mxnet_tpu_torch.monitor import events
    from incubator_mxnet_tpu_torch.ops import nms
    from incubator_mxnet_tpu_torch.serving import GenerationEngine
    t0 = time.monotonic()
    mx.random.seed(0)
    net = mx.models.Seq2Seq(S2S_VOCAB, S2S_VOCAB, embed_dim=24, hidden=32,
                            num_layers=2, device="cuda:0")
    # bench.py's default Uniform(0.07) makes every prompt decode to the
    # same tokens; at this scale they depend on the prompt
    net.initialize(mx.init.Normal(S2S_INIT_SIGMA), ctx="cuda:0",
                   force_reinit=True)
    _reset_counts(att)                  # the phase's path starts here
    conv0, nms0 = cs.conv1x1_stats_launches, nms.nms_launches
    eng = GenerationEngine(net, bos=NMT_BOS, eos=GEN_EOS, slots=S2S_SLOTS,
                           max_len=S2S_MAX_LEN, prompt_buckets=S2S_BUCKETS,
                           queue_cap=64)
    try:
        c0 = events.get("serve.traces")
        warm = eng.warmup()
        captures = events.get("serve.traces") - c0
        rs = np.random.RandomState(0)
        prompts = [rs.randint(3, S2S_VOCAB, (n,)).astype(np.int32)
                   for n in S2S_PROMPT_LENGTHS]
        c1 = events.get("serve.traces")
        streams = [eng.submit(p, max_new_tokens=S2S_MAX_NEW)
                   for p in prompts]
        got = [s.result(timeout=GEN_RESULT_TIMEOUT) for s in streams]
        traffic_captures = events.get("serve.traces") - c1
        requests = []
        with torch.no_grad():
            for p, g in zip(prompts, got):
                ref, _, gaps = _greedy(torch, net, p, S2S_MAX_NEW, "cuda:0",
                                       max_len=S2S_MAX_LEN,
                                       mem_len=max(S2S_BUCKETS))
                requests.append(dict(
                    prompt_len=int(p.size), tokens=[int(t) for t in g],
                    on_bucket=int(p.size) in S2S_BUCKETS,
                    **_near_tie_compare(g, ref, gaps, SERVE_TOL)))
        with eng._exec_lock, torch.no_grad():
            prog, eager_fn = eng._programs["decode"], eng._decode_fn()
            replay_ms = _event_ms(torch, prog.replay, S2S_TIMED_STEPS)
            eager_ms = _event_ms(torch, eager_fn, S2S_TIMED_STEPS)
    finally:
        eng.close()
    launches = dict(zip(_COUNT_KEYS, _all_counts(att)),
                    conv=cs.conv1x1_stats_launches - conv0,
                    nms=nms.nms_launches - nms0)
    out = dict(phase="generate_seq2seq", model="Seq2Seq(31, 31, embed 24, "
               "hidden 32, 2 layers)", dtype="float32", slots=S2S_SLOTS,
               max_len=S2S_MAX_LEN, prompt_buckets=list(S2S_BUCKETS),
               warmup_captures=captures, traffic_captures=traffic_captures,
               warmup_wall_s=warm["wall_s"], kv_cache_bytes=warm["kv_cache"],
               requests=requests, tol=SERVE_TOL,
               decode_step=dict(replay_ms=replay_ms, eager_ms=eager_ms,
                                eager_over_replay=eager_ms / replay_ms,
                                steps=S2S_TIMED_STEPS),
               launches=launches, nvidia_smi=_nvidia_smi(),
               wall_s=time.monotonic() - t0)
    _emit(out)
    _check(captures == len(S2S_BUCKETS) + 2, "generate_seq2seq: warmup made "
           "%d captures, want %d" % (captures, len(S2S_BUCKETS) + 2))
    _check(traffic_captures == 0, "generate_seq2seq: traffic captured %d "
           "programs" % traffic_captures)
    for p, g in zip(prompts, got):
        _check(1 <= g.size <= S2S_MAX_NEW and (g.size == S2S_MAX_NEW
                                                or g[-1] == GEN_EOS),
               "generate_seq2seq: a request of budget %d returned %d "
               "tokens" % (S2S_MAX_NEW, g.size))
    _check(not any(launches.values()), "generate_seq2seq launched port "
           "kernels: %r" % (launches,))
    return out


def _rnn_case_inputs(mode, bi, varlen, rs):
    """(data, flat vector, h0[, c0]) as f32 arrays, and the lengths for
    a varlen case."""
    from incubator_mxnet_tpu_torch.ops.rnn import rnn_param_size
    d = 2 if bi else 1
    n = rnn_param_size(mode, RNN_LAYERS, RNN_I, RNN_H, bi)
    arrays = [rs.randn(RNN_T, RNN_B, RNN_I), rs.uniform(-0.2, 0.2, n),
              rs.randn(RNN_LAYERS * d, RNN_B, RNN_H) * 0.5]
    if mode == "lstm":
        arrays.append(rs.randn(RNN_LAYERS * d, RNN_B, RNN_H) * 0.5)
    arrays = [a.astype(np.float32) for a in arrays]
    lengths = np.array(RNN_LENGTHS, np.int32) if varlen else None
    return arrays, lengths


def _rnn_cotangents(mode, bi, rs):
    """Seeded cotangents of the op's outputs: y, h (and c)."""
    d = 2 if bi else 1
    shapes = [(RNN_T, RNN_B, RNN_H * d)] + [
        (RNN_LAYERS * d, RNN_B, RNN_H)] * (2 if mode == "lstm" else 1)
    return [rs.uniform(-1, 1, s).astype(np.float32) for s in shapes]


def _rnn_run(torch, mx, mode, bi, arrays, lengths, cots, dev, dtype):
    """nd.RNN (nd.RNN_varlen with `lengths`) on `dev` in `dtype`: the
    outputs and the gradients of every input for the cotangents `cots`,
    as f32 CPU tensors."""
    nds = [mx.nd.array(torch.from_numpy(a).to(dtype), ctx=dev)
           for a in arrays]
    for a in nds:
        a.attach_grad()
    kw = dict(state_size=RNN_H, num_layers=RNN_LAYERS, bidirectional=bi,
              mode=mode)
    with mx.autograd.record():
        if lengths is None:
            outs = mx.nd.RNN(*nds, **kw)
        else:
            args = nds + ([] if mode == "lstm" else [None])
            outs = mx.nd.RNN_varlen(*args, mx.nd.array(lengths, ctx=dev,
                                                       dtype="int32"), **kw)
    outs = list(outs)
    heads = [mx.nd.array(torch.from_numpy(c).to(dtype), ctx=dev)
             for c in cots]
    grads = mx.autograd.grad(outs, nds, head_grads=heads)
    return [t._data.detach().float().cpu() for t in outs + list(grads)]


def rnn_bf16_over_rule(torch, mx, mode, bi, arrays, lengths, cots, dev):
    """The bf16 op on `dev` against an f32 CPU run of the same bf16
    values: each output's and gradient's error over its bound, the
    largest (the check holds at <= 1).  The bound is BF16_ROUTE_FACTOR x
    the larger of the CPU's own bf16 error and that error with every
    input nudged by 1 +- RNN_NUDGE (a rounding of each), plus one bf16 ulp of
    the tensor's scale.  The nudge is what makes it hold rnn_relu too:
    there a pre-activation a rounding away from 0 switches the ReLU's
    gradient, and its data and weight gradients move by 0.1-0.6 of
    their scale (train_resnet's spread rule, in bf16); in the smooth
    modes the nudged error is 1-3x the plain one."""
    def bf16_values(a):
        return torch.from_numpy(a).bfloat16().float().numpy()
    r16, c16 = [bf16_values(a) for a in arrays], [bf16_values(c)
                                                   for c in cots]
    gen = np.random.RandomState(1)
    nudged = [(a * (1 + RNN_NUDGE * (gen.randint(0, 2, a.shape) * 2 - 1)))
              .astype(np.float32) for a in r16]

    def run(inputs, cot, device, dtype):
        return _rnn_run(torch, mx, mode, bi, inputs, lengths, cot, device,
                        dtype)
    ref = run(r16, c16, "cpu", torch.float32)
    worst = 0.0
    for a, b, n, r in zip(run(arrays, cots, dev, torch.bfloat16),
                          run(arrays, cots, "cpu", torch.bfloat16),
                          run(nudged, cots, "cpu", torch.bfloat16), ref):
        scale = max(r.abs().max().item(), 1e-30)
        e_cpu = max((b - r).abs().max().item(),
                    (n - r).abs().max().item()) / scale
        worst = max(worst, (a - r).abs().max().item() / scale / (
            BF16_ROUTE_FACTOR * e_cpu + _bf16_ulp_share(scale)))
    return worst


def _rnn_yardstick(torch, mx):
    """One GNMT encoder layer (T 50, B 128, 1024 -> 1024): the port's
    LSTM against torch.nn.LSTM on the same weights.  f32: outputs, final
    states and the gradients of the input and the weights within RNN_TOL
    of scale.  bf16: forward + backward ms by CUDA events (median of
    YARD_REPS) of the port's layer eager and hybridized and of cuDNN's,
    each with its kernels a call and device ms by the profiler, beside
    the bound (the GEMMs' operations at the bf16 peak)."""
    T, B, H = YARD_T, YARD_B, YARD_H
    rs = np.random.RandomState(7)
    x0 = torch.from_numpy(rs.randn(T, B, H).astype(np.float32)).cuda()
    gy0 = torch.from_numpy(rs.uniform(-1, 1, (T, B, H)).astype(
        np.float32)).cuda()

    def pair(dtype):
        mx.random.seed(0)
        port = mx.gluon.rnn.LSTM(H, input_size=H, device="cuda:0")
        ref = torch.nn.LSTM(H, H).cuda()
        flat = port.flat_param.detach()
        n = 4 * H * H
        with torch.no_grad():
            for w, src in ((ref.weight_ih_l0, flat[:n]),
                           (ref.weight_hh_l0, flat[n:2 * n]),
                           (ref.bias_ih_l0, flat[2 * n:2 * n + 4 * H]),
                           (ref.bias_hh_l0, flat[2 * n + 4 * H:])):
                w.copy_(src.reshape(w.shape))
        port.cast(dtype)
        ref = ref.to(dtype)
        ref.flatten_parameters()
        return port, ref

    def port_step(port, x, gy):
        with mx.autograd.record():
            y = port(x)
        mx.autograd.backward(y, gy)
        return y

    def ref_step(ref, x, gy):
        x.grad = None
        ref.zero_grad(set_to_none=True)
        y, _ = ref(x)
        y.backward(gy)
        return y

    port, ref = pair(torch.float32)
    grads = []
    for fn, m, wts in ((port_step, port, [port.flat_param]),
                       (ref_step, ref, [ref.weight_ih_l0, ref.weight_hh_l0,
                                        ref.bias_ih_l0])):
        x = x0.clone().requires_grad_()
        y = fn(m, x, gy0)
        grads.append([y.detach()] + [x.grad] + [w.grad.clone()
                                                for w in wts])
    pg = grads[0][2]
    n = 4 * H * H
    port_side = [grads[0][0], grads[0][1], pg[:n].reshape(4 * H, H),
                 pg[n:2 * n].reshape(4 * H, H), pg[2 * n:2 * n + 4 * H]]
    f32_err = max((a - b).abs().max().item() / max(b.abs().max().item(),
                                                   1.0)
                  for a, b in zip(port_side, grads[1]))
    del port, ref, grads, pg, port_side
    torch.cuda.empty_cache()

    port, ref = pair(torch.bfloat16)
    hyb, _ = pair(torch.bfloat16)
    hyb.hybridize(static_alloc=True, static_shape=True)
    x16, gy16 = x0.bfloat16().requires_grad_(), gy0.bfloat16()
    rows = {}
    for name, fn, m in (("port_eager", port_step, port),
                        ("port_hybridized", port_step, hyb),
                        ("cudnn", ref_step, ref)):
        call = lambda fn=fn, m=m: fn(m, x16, gy16)      # noqa: E731
        for _ in range(2):      # eager, and the capture when hybridized
            call()
        ms = _event_ms(torch, call, YARD_REPS)
        kern, wall_us = _device_kernels(torch, call, 2)
        rows[name] = dict(ms=ms, kernels_per_call=sum(
            k[2] for k in kern) / 2, device_ms=sum(k[0] for k in kern)
            / 2e3, busy_share=sum(k[0] for k in kern) / wall_us,
            top=[dict(kernel=k[:80], us=us / 2, calls=c / 2)
                 for us, k, c in kern[:4]])
    flops = 3 * 2 * T * B * 4 * H * (2 * H)     # forward and 2x backward
    bound_ms = flops / 989e12 * 1e3
    out = dict(shape=dict(T=T, B=B, I=H, H=H), dtype="bfloat16",
               f32_err_over_scale=f32_err, f32_tol=RNN_TOL,
               bound_ms=bound_ms, bound_by="operations", **rows,
               port_eager_over_cudnn=rows["port_eager"]["ms"]
               / rows["cudnn"]["ms"],
               port_hybridized_over_cudnn=rows["port_hybridized"]["ms"]
               / rows["cudnn"]["ms"])
    del port, ref, hyb
    torch.cuda.empty_cache()
    return out


def phase_rnn(torch, mx):
    """Each mode (lstm, gru, rnn_tanh, rnn_relu) x {uni, bi} x {dense,
    varlen} through nd.RNN / nd.RNN_varlen (2 layers, T 12, B 4, 16 ->
    32, lengths 12, 9, 5, 1), forward and the gradients of data, flat
    vector and states, on the card against a CPU copy: f32 within RNN_TOL
    of scale, bf16 by the train_bf16 rule against an f32 CPU run.  Then
    the yardstick (`_rnn_yardstick`), which is not on any path."""
    t0 = time.monotonic()
    rs = np.random.RandomState(5)
    rows, failed = [], []
    for mode in ("lstm", "gru", "rnn_tanh", "rnn_relu"):
        for bi in (False, True):
            for varlen in (False, True):
                arrays, lengths = _rnn_case_inputs(mode, bi, varlen, rs)
                cots = _rnn_cotangents(mode, bi, rs)
                run = functools.partial(_rnn_run, torch, mx, mode, bi,
                                        arrays, lengths, cots)
                row = dict(mode=mode, bi=bi, varlen=varlen)
                card, cpu = run("cuda:0", torch.float32), \
                    run("cpu", torch.float32)
                row["f32_err_over_scale"] = max(
                    (a - b).abs().max().item() / max(b.abs().max().item(),
                                                     1.0)
                    for a, b in zip(card, cpu))
                worst = rnn_bf16_over_rule(torch, mx, mode, bi, arrays,
                                           lengths, cots, "cuda:0")
                row["bf16_err_over_rule"] = worst
                rows.append(row)
                if row["f32_err_over_scale"] > RNN_TOL or worst > 1.0:
                    failed.append(row)
    yard = _rnn_yardstick(torch, mx)
    _emit(dict(phase="rnn", cases=rows, f32_tol=RNN_TOL,
               bf16_rule="e_card <= %g max(e_cpu_bf16, e_cpu_bf16_nudged) "
               "+ ulp" % BF16_ROUTE_FACTOR, nudge=RNN_NUDGE,
               yardstick=yard, nvidia_smi=_nvidia_smi(),
               wall_s=time.monotonic() - t0))
    _check(not failed, "rnn: cases differ from the CPU copy: %r" % failed)
    _check(yard["f32_err_over_scale"] <= RNN_TOL, "rnn: the port's LSTM "
           "differs from torch.nn.LSTM at the GNMT layer shape by %g of "
           "scale" % yard["f32_err_over_scale"])


# -- train_wide_deep: Wide&Deep, dense and row_sparse ------------------------

# bench.py's config 5 (run_wide_deep, bench.py:547-608): 100,000 features
# in 16 fields, embed 16, MLP 64-32, 2 classes, Adam lr 1e-3; the dense
# headline at the first rung of _cfg_wide_deep's ladder (bench.py:3232),
# the row_sparse path at the batch of bench.py:3270
WD_FEATURES = 100_000
WD_FIELDS = 16
WD_EMBED = 16
WD_HIDDEN = (64, 32)
WD_CLASSES = 2
WD_LR = 1e-3
WD_BATCH = 32768
WD_SPARSE_BATCH = 2048
WD_PARITY_BATCH = 512       # the f32 step held against the CPU copy
WD_NUDGE = 2.0 ** -22       # the CPU copy's spread: every weight nudged
WD_SPARSE_WARMUP = 3        # bench.py's: eager, capturing, replayed
# the eager sparse path against the bucketed one: four batches whose ids
# come from pools of these sizes, so that their unique counts differ
# widely (tests/python/unittest/test_sparse.py:280-353 at full width);
# the first pool holds the last row, the others do not
WD_POOLS = (50, 2000, 20000, 300)
# Both paths compute the same lazy Adam (the JAX package's sparse update
# and sparse_jit.BucketedSparseTrainer) and differ in the lr's rounding
# (f64 on the host against f32 on the card), the order of the update's
# operations and of the gradient's sums (torch's coalesce against
# index_add_, the batch mean before or after the sum).  Where a gradient
# element is a near-cancelling sum (a bias's mean over the batch) its few
# rounding-level bits of difference reach the update through Adam's eps
# zone (sqrt(v) near eps), which the CPU at test sizes shows at 8e-6 of a
# bias's scale; so each tensor is held to 1e-3 of its scale (max-abs
# error over max-abs value) and the losses within 1e-5.  The wide table's
# gradient is 0 in exact arithmetic (its term adds the same value to both
# logits, which the softmax ignores): its rounding noise sits far below
# eps, so Adam moves it by about lr * noise / eps, and it is held to the
# same limit.  A lazy-update fault (a row updated that the batch did not
# touch, or left out) moves a row by about lr, 1e-2 of the tables' scale
# (Uniform(0.07)), 10x the limit.
WD_SPARSE_TOL = 1e-3
WD_LOSS_TOL = 1e-5
WD_OVERFLOW_BUCKET = 4096   # (d): bucket_rows below the big batch's ~28k
WD_FIT_POOL = 1000          # (d): a batch that fits the bucket
# the card; the CPU tests run (c) and (d) with the CPU in its place
WD_DEVICE = "cuda:0"


def _wd_net(mx, sparse_grad, device=None):
    """bench.py's `wide_deep` at config 5's widths, initialized on
    `device` from seed 0, its widths still deferred."""
    device = device or WD_DEVICE
    mx.random.seed(0)
    net = mx.models.wide_deep(num_features=WD_FEATURES, embed_dim=WD_EMBED,
                              hidden=WD_HIDDEN, classes=WD_CLASSES,
                              sparse_grad=sparse_grad)
    net.initialize(ctx=device)
    return net


def _wd_data(torch, batch, device=None):
    """run_wide_deep's indices, values and labels, drawn in that order
    from RandomState(0)."""
    rs = np.random.RandomState(0)
    idx = rs.randint(0, WD_FEATURES, (batch, WD_FIELDS)).astype(np.int32)
    vals = rs.rand(batch, WD_FIELDS).astype(np.float32)
    y = rs.randint(0, 2, batch).astype(np.float32)
    return [torch.from_numpy(a).to(device or WD_DEVICE)
            for a in (idx, vals, y)]


def _wd_materialize(mx, net, idx, vals):
    """The MLP's deferred widths, from one inference forward."""
    with mx.autograd.pause():
        net(idx[:2], vals[:2])
    return net


def _wd_bound(batch):
    """The least time of one dense step (ms, and what bounds it): the
    gathered embeddings written and read in the forward and their
    gradient in the backward, every parameter's weight, gradient and two
    Adam states read and written once, over HBM's rate; the MLP's
    forward and backward products on the CUDA cores (TF32 off)."""
    params = WD_FEATURES * (WD_EMBED + 1)
    width = WD_FIELDS * WD_EMBED
    mlp = 0
    for n in WD_HIDDEN + (WD_CLASSES,):
        mlp += width * n + n
        width = n
    params += mlp
    nbytes = 4 * (4 * batch * WD_FIELDS * WD_EMBED) + 8 * 4 * params
    flops = 6 * batch * mlp
    byte_ms = nbytes / PEAK_BYTES_S * 1e3
    op_ms = flops / PEAK_FLOPS_F32_CUDA_CORES * 1e3
    return dict(bound_ms=max(byte_ms, op_ms),
                bound_by="bytes" if byte_ms >= op_ms else "operations",
                bytes=nbytes, flops=flops, parameters=params)


def _wd_grads(mx, net, loss_fn, idx, vals, y):
    with mx.autograd.record():
        loss = loss_fn(net(idx, vals), y)
    mx.autograd.backward(loss)
    return loss.detach().cpu(), {
        n: p.grad.detach().float().cpu().clone()
        for n, p in net.collect_params().items()}


def _wd_parity(torch, mx):
    """One f32 dense step at batch WD_PARITY_BATCH on the card against a
    CPU copy: the loss within SERVE_TOL, the gradients by
    `_spread_parity` against the CPU copy's spread with every weight
    nudged by 1 +- WD_NUDGE."""
    idx, vals, y = _wd_data(torch, WD_PARITY_BATCH, "cpu")
    dev = WD_DEVICE
    net = _wd_materialize(mx, _wd_net(mx, False), idx.to(dev), vals.to(dev))
    cpu = _wd_materialize(mx, _wd_net(mx, False, "cpu"), idx, vals)
    cpu.load_state_dict({k: v.detach().cpu()
                         for k, v in net.state_dict().items()})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    loss, grads = _wd_grads(mx, net, loss_fn, idx.to(dev), vals.to(dev),
                            y.to(dev))
    ref_loss, ref_grads = _wd_grads(mx, cpu, loss_fn, idx, vals, y)
    nudge_weights(torch, (cpu,), WD_NUDGE)
    _, spread = _wd_grads(mx, cpu, loss_fn, idx, vals, y)
    del net, cpu
    return dict(batch=WD_PARITY_BATCH, dtype="float32", nudge=WD_NUDGE,
                loss_max_abs_err=(loss - ref_loss).abs().max().item(),
                loss_tol=SERVE_TOL,
                **_spread_parity(torch, grads, ref_grads, spread))


def _wd_sparse_run(torch, mx):
    """(b): BucketedSparseTrainer (Adam, lr 1e-3) at batch 2,048 as
    run_wide_deep(sparse=True) drives it: WD_SPARSE_WARMUP steps, then
    TRAIN_STEPS timed (CUDA events) and PROFILE_STEPS profiled."""
    from incubator_mxnet_tpu_torch.contrib.sparse_jit import \
        BucketedSparseTrainer
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    idx, vals, y = _wd_data(torch, WD_SPARSE_BATCH)
    net = _wd_materialize(mx, _wd_net(mx, True), idx, vals)
    jt = BucketedSparseTrainer(net, optimizer="adam", lr=WD_LR)

    def counts():
        return dict(captures=jt.captures, replays=jt.replays,
                    eager_steps=jt.eager_steps)
    for _ in range(WD_SPARSE_WARMUP):
        jt.step(idx, vals, y)
    torch.cuda.synchronize()
    warm = counts()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(TRAIN_STEPS + 1)]
    losses = []
    t0 = time.perf_counter()
    events[0].record()
    for i in range(TRAIN_STEPS):
        losses.append(jt.step(idx, vals, y))
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    timed = {k: v - warm[k] for k, v in counts().items()}
    rows, wall_us = _device_kernels(torch, lambda: jt.step(idx, vals, y),
                                    PROFILE_STEPS)
    device_us = sum(r[0] for r in rows)
    step_ms = [events[i].elapsed_time(events[i + 1])
               for i in range(TRAIN_STEPS)]
    out = dict(batch=WD_SPARSE_BATCH, step_ms=step_ms,
               step_ms_median=statistics.median(step_ms),
               samples_per_s=TRAIN_STEPS * WD_SPARSE_BATCH / wall,
               losses=[float(v.item()) for v in losses],
               unique_rows_per_step=int(np.unique(idx.cpu().numpy()).size),
               vocabulary=WD_FEATURES, bucket_keys=jt.bucket_keys,
               programs=dict(after_warmup=warm, during_timed_steps=timed),
               overflow_steps=jt.overflow_steps,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               profile=dict(steps=PROFILE_STEPS, wall_us=wall_us,
                            device_us=device_us,
                            busy_share=device_us / wall_us,
                            kernels_per_step=sum(n for _, _, n in rows)
                            / PROFILE_STEPS,
                            port_kernels=_port_kernel_calls(rows,
                                                            PROFILE_STEPS),
                            top=[dict(kernel=k[:80], us=us, calls=n)
                                 for us, k, n in rows[:8]]))
    _check(warm == dict(captures=1, replays=WD_SPARSE_WARMUP - 2,
                        eager_steps=1) and len(jt.bucket_keys) == 1,
           "train_wide_deep: the bucketed warm-up did not run one eager "
           "step, one capture and replays of one key: %r" % (out,))
    _check(timed == dict(captures=0, replays=TRAIN_STEPS, eager_steps=0),
           "train_wide_deep: the bucketed timed steps did not only "
           "replay: %r" % (timed,))
    _check(out["overflow_steps"] == 0 and all(
        math.isfinite(v) for v in out["losses"]),
        "train_wide_deep: the bucketed path overflowed or lost its loss: "
        "%r" % (out,))
    _check(not out["profile"]["port_kernels"], "train_wide_deep: the "
           "sparse path launched a port kernel: %r" % (out["profile"],))
    return out


def _wd_sparse_batches(torch):
    """(c)'s four batches at batch 2,048 (module constants)."""
    rs = np.random.RandomState(1)
    last = WD_FEATURES - 1
    out = []
    for k, n in enumerate(WD_POOLS):
        pool = rs.choice(WD_FEATURES, size=n, replace=False)
        pool = np.concatenate([[last], pool]) if k == 0 else \
            pool[pool != last]
        idx = rs.choice(pool, size=(WD_SPARSE_BATCH, WD_FIELDS))
        vals = rs.rand(WD_SPARSE_BATCH, WD_FIELDS).astype(np.float32)
        y = rs.randint(0, 2, WD_SPARSE_BATCH).astype(np.float32)
        out.append([torch.from_numpy(a).to(WD_DEVICE) for a in
                    (idx.astype(np.int32), vals, y)])
    return out


def _planted_dense_adam(mx):
    """A fault for (c): the eager path's lazy Adam made dense (every row
    of the table updated, the untouched ones from a zero gradient).
    Returns the function that removes it."""
    sp = mx.nd.sparse
    orig = sp.sparse_adam_update

    def dense_adam(weight, grad_rsp, *args, **kwargs):
        full = grad_rsp.tostype("default")
        rows = mx.nd.NDArray(np.arange(full.shape[0]), ctx=full.context,
                             dtype="int32")
        every = sp.RowSparseNDArray(rows, full, full.shape)
        return orig(weight, every, *args, **kwargs)
    sp.sparse_adam_update = dense_adam
    return lambda: setattr(sp, "sparse_adam_update", orig)


def _wd_sparse_parity(torch, mx, batches, planted=None):
    """(c): the Gluon user's eager sparse path (Embedding(sparse_grad),
    the net hybridized, SoftmaxCrossEntropyLoss, Trainer Adam lr 1e-3)
    against BucketedSparseTrainer from the same initial parameters over
    `batches`, with the fault `planted` ("dense_adam" in the eager path,
    "sentinel" one row low in the bucketed one) or none.  The row and
    whether it holds (WD_SPARSE_TOL's comment)."""
    from incubator_mxnet_tpu_torch.contrib.sparse_jit import \
        BucketedSparseTrainer
    idx0, vals0, _ = batches[0]
    net_e = _wd_materialize(mx, _wd_net(mx, True), idx0, vals0)
    net_j = _wd_materialize(mx, _wd_net(mx, True), idx0, vals0)
    init = {k: v.detach().clone() for k, v in net_e.state_dict().items()}
    net_j.load_state_dict(init)
    net_e.hybridize()
    trainer = mx.gluon.Trainer(net_e.collect_params(), "adam",
                               {"learning_rate": WD_LR})
    sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    jt = BucketedSparseTrainer(net_j, optimizer="adam", lr=WD_LR)
    if planted == "sentinel":
        jt._sentinel = WD_FEATURES - 1
    undo = _planted_dense_adam(mx) if planted == "dense_adam" else None
    losses = []
    try:
        for idx, vals, y in batches:
            with mx.autograd.record():
                loss = sce(net_e(idx, vals), y)
            mx.autograd.backward(loss)
            trainer.step(idx.shape[0])
            losses.append((float(loss.mean().item()),
                           float(jt.step(idx, vals, y).item())))
    finally:
        if undo is not None:
            undo()
    jt.sync_to_net()
    pe = dict(net_e.named_parameters())
    pj = dict(net_j.named_parameters())
    tables = (jt._wide_name, jt._deep_name)
    touched = torch.zeros(WD_FEATURES, dtype=torch.bool, device=WD_DEVICE)
    for idx, _, _ in batches:
        touched[idx.reshape(-1).long()] = True
    untouched = ~touched
    errs = {n: (pe[n] - pj[n]).abs().max().item()
            / pe[n].abs().max().item() for n in pe}
    same = {n: bool(torch.equal(pe[n][untouched], init[n][untouched])
                    and torch.equal(pj[n][untouched], init[n][untouched]))
            for n in tables}
    graph = net_e._cached_graph
    row = dict(planted=planted,
               unique_rows=[int(np.unique(b[0].cpu().numpy()).size)
                            for b in batches],
               untouched_rows=int(untouched.sum().item()),
               losses=losses,
               loss_max_abs_err=max(abs(a - b) for a, b in losses),
               loss_tol=WD_LOSS_TOL,
               err_over_scale=errs, worst=max(errs, key=errs.get),
               tol=WD_SPARSE_TOL, untouched_rows_bit_equal=same,
               eager_net=dict(captures=graph.captures,
                              eager_calls=graph.eager_calls),
               trainer=dict(sparse_updates=trainer.sparse_updates,
                            captures=trainer.captures),
               bucketed=dict(captures=jt.captures, replays=jt.replays,
                             eager_steps=jt.eager_steps,
                             bucket_keys=jt.bucket_keys))
    ok = (row["loss_max_abs_err"] <= WD_LOSS_TOL
          and max(errs.values()) <= WD_SPARSE_TOL and all(same.values()))
    return row, ok


def _wd_state(jt):
    st = jt._state
    flat = {"t": st["t"], "overflow": st["overflow"], "loss": st["loss"]}
    for part in ("tables", "dense", "m", "v"):
        flat.update({part + ":" + n: t for n, t in st.get(part, {}).items()})
    return {n: t.clone() for n, t in flat.items()}


def _wd_overflow(torch, mx):
    """(d): bucket_rows WD_OVERFLOW_BUCKET; two steps of a batch that fits
    (eager, capturing), then a replayed step of run_wide_deep's batch,
    whose unique rows overflow the bucket: skipped on the card."""
    from incubator_mxnet_tpu_torch.contrib.sparse_jit import \
        BucketedSparseTrainer
    idx, vals, y = _wd_data(torch, WD_SPARSE_BATCH)
    rs = np.random.RandomState(2)
    pool = rs.choice(WD_FEATURES, size=WD_FIT_POOL, replace=False)
    fit = torch.from_numpy(rs.choice(pool, size=tuple(idx.shape))
                           .astype(np.int32)).to(WD_DEVICE)
    net = _wd_materialize(mx, _wd_net(mx, True), idx, vals)
    jt = BucketedSparseTrainer(net, optimizer="adam", lr=WD_LR,
                               bucket_rows=WD_OVERFLOW_BUCKET)
    jt.step(fit, vals, y)
    prev = float(jt.step(fit, vals, y).item())
    before = _wd_state(jt)
    got = float(jt.step(idx, vals, y).item())
    after = _wd_state(jt)
    # the overflow counter is the one field a skipped step advances
    changed = sorted(n for n in before if n != "overflow"
                     and not _same_bits(torch, before[n], after[n]))
    n_over = jt.overflow_steps
    resumed = float(jt.step(fit, vals, y).item())
    row = dict(bucket_rows=WD_OVERFLOW_BUCKET,
               unique_rows=int(np.unique(idx.cpu().numpy()).size),
               fit_unique_rows=int(np.unique(fit.cpu().numpy()).size),
               overflow_steps=n_over, previous_loss=prev,
               returned_loss=got, changed_state=changed,
               resumed_loss=resumed,
               overflow_steps_after=jt.overflow_steps,
               programs=dict(captures=jt.captures, replays=jt.replays,
                             eager_steps=jt.eager_steps))
    ok = (n_over == 1 and got == prev and not changed
          and math.isfinite(resumed) and jt.overflow_steps == 1
          and jt.captures == 1 and jt.replays == 2)
    return row, ok


def phase_train_wide_deep(torch, mx, att, cs):
    """bench.py's config 5, Wide&Deep, on the card: (a) the
    dense headline, run_wide_deep at batch 32,768 (hybridized net and
    loss, Adam), eager and hybridized from the same weights and data
    through `phase_hybridize` (bit for bit, 0 captures in the timed
    steps, no port kernel), with one f32 step against a CPU copy by the
    spread rule and the step's bound; (b) the row_sparse path,
    BucketedSparseTrainer at batch 2,048, one capture for its one key;
    (c) the Gluon user's eager sparse path against (b) over four
    batches, then with a dense Adam and with an off-by-one sentinel
    planted, each of which the check must refuse; (d) an overflowing
    bucket skipped on the card.  Prints the card's name and power
    limit."""
    t0 = time.monotonic()
    parity = _wd_parity(torch, mx)
    gc.collect()
    torch.cuda.empty_cache()
    idx, vals, y = _wd_data(torch, WD_BATCH)

    def build():
        net = _wd_materialize(mx, _wd_net(mx, False), idx, vals)
        return net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), \
            mx.gluon.Trainer(net.collect_params(), "adam",
                             {"learning_rate": WD_LR})

    def step(net, head, trainer):
        with mx.autograd.record():
            loss = head(net(idx, vals), y)
        mx.autograd.backward(loss)
        trainer.step(WD_BATCH)
        return loss.detach().mean()
    dense = phase_hybridize(torch, mx, att, cs, "train_wide_deep", build,
                            step, WD_BATCH, (0,) * 8)
    del idx, vals, y
    gc.collect()
    torch.cuda.empty_cache()
    sparse = _wd_sparse_run(torch, mx)
    batches = _wd_sparse_batches(torch)
    eager_sparse, eager_ok = _wd_sparse_parity(torch, mx, batches)
    planted = {}
    for fault in ("dense_adam", "sentinel"):
        planted[fault] = _wd_sparse_parity(torch, mx, batches, fault)
    overflow, overflow_ok = _wd_overflow(torch, mx)
    out = dict(phase="train_wide_deep", config="bench.py config 5",
               features=WD_FEATURES, fields=WD_FIELDS, embed=WD_EMBED,
               hidden=list(WD_HIDDEN), classes=WD_CLASSES,
               optimizer="adam", learning_rate=WD_LR,
               nvidia_smi=_nvidia_smi(),
               dense=dict(batch=WD_BATCH, **_summary(dense),
                          samples_per_s=dense["units_per_s"],
                          step_ms=dense["step_ms"], losses=dense["losses"],
                          programs=dense["programs"],
                          kernels_per_replayed_step=dense["profile"][
                              "kernels_per_step"],
                          kernel_names_per_replayed_step=len(
                              dense["kernel_names"]),
                          top_kernels=dense["profile"]["top"],
                          eager_vs_hybridized=dense["compare"],
                          **_wd_bound(WD_BATCH)),
               parity=parity, sparse=sparse, eager_sparse=eager_sparse,
               planted={k: v[0] for k, v in planted.items()},
               planted_refused={k: not v[1] for k, v in planted.items()},
               overflow=overflow, wall_s=time.monotonic() - t0)
    _emit(out)
    cmp = dense["compare"]
    _check(cmp["losses_bit_equal"] and cmp["params_bit_equal"],
           "train_wide_deep: eager and hybridized differ: %r" % (cmp,))
    _check(parity["loss_max_abs_err"] <= SERVE_TOL,
           "train_wide_deep: the f32 step's loss differs from the CPU "
           "copy's: %r" % (parity,))
    _spread_checks("train_wide_deep", parity)
    _check(eager_ok, "train_wide_deep: the eager sparse path differs from "
           "the bucketed one: %r" % (eager_sparse,))
    _check(eager_sparse["eager_net"]["captures"] == 0
           and eager_sparse["eager_net"]["eager_calls"] == len(batches)
           and eager_sparse["trainer"]["sparse_updates"] == len(batches),
           "train_wide_deep: the hybridized sparse-gradient net did not run "
           "its recorded calls eagerly: %r" % (eager_sparse,))
    _check(all(out["planted_refused"].values()),
           "train_wide_deep: a planted fault passed the eager-against-"
           "bucketed check: %r" % (out["planted"],))
    _check(overflow_ok, "train_wide_deep: the overflowing bucket was not "
           "skipped on the card: %r" % (overflow,))
    return out


# train_sharded: bench.py's `sharded` config (build_sharded_trainer /
# run_sharded): resnet50_v1b, 1000 classes, 224^2, bf16 parameters but
# BatchNorm's gamma, beta and running statistics, SGD momentum 0.9, lr
# 0.1, wd 1e-4, the largest batch of the ladder that fits, 2 warm-up and
# 16 timed steps
SHARDED_BATCHES = (256, 128, 64)
SHARDED_WARMUP = 2
SHARDED_STEPS = 16
SHARDED_SGD = dict(optimizer="sgd", lr=0.1, momentum=0.9, wd=1e-4)
SHARDED_SWEEP_STEPS = 3
SHARDED_PARITY_BATCH = 4
# kvstore: a Gluon resnet18_v1 loop on the card, batch 32 at 224^2
KV_BATCH = 32
KV_STEPS = 3
KV_SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


def _sharded_net(torch, mx, device):
    """resnet50_v1b(classes=1000) on `device`, its stem completed by one
    inference forward, as bench.py's build_sharded_trainer does."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import \
        resnet50_v1b
    mx.random.seed(0)
    net = resnet50_v1b(classes=1000, device=device)
    with mx.autograd.pause():
        net(torch.zeros(2, 3, 224, 224, device=device))
    return net


def _sharded_trainer(torch, mx, net, **kw):
    """bench.py's trainer: bf16 parameters but BatchNorm's gamma, beta
    and running statistics, and the optimizer state made anew from
    them."""
    from incubator_mxnet_tpu_torch import parallel
    t = parallel.ShardedTrainer(net, **dict(SHARDED_SGD, **kw))
    t.params = {k: (v.to(torch.bfloat16) if v.dtype == torch.float32
                    and "running" not in k and "gamma" not in k
                    and "beta" not in k else v)
                for k, v in t.params.items()}
    t.opt_state = t._opt_init(t.params)
    return t


def _sharded_batch(torch, batch):
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(batch, 3, 224, 224).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 1000, batch).astype(np.int64))
    return x.cuda().to(torch.bfloat16), y.cuda()


def _sharded_fit(torch, mx, net):
    """The largest batch of SHARDED_BATCHES whose warm-up steps (one
    eager, one capturing) fit; (batch, trainer, x, y, losses)."""
    for batch in SHARDED_BATCHES:
        t = None
        try:
            t = _sharded_trainer(torch, mx, net)
            x, y = _sharded_batch(torch, batch)
            losses = [t.step(x, y) for _ in range(SHARDED_WARMUP)]
            torch.cuda.synchronize()
            return batch, t, x, y, losses
        except torch.cuda.OutOfMemoryError:
            if t is not None:
                t.release()
            del t
            gc.collect()
            torch.cuda.empty_cache()
    raise RuntimeError("no batch of %s fits" % (SHARDED_BATCHES,))


def _sharded_deltas(torch, t, before):
    """{trainable name: its change over the last step, on the CPU, f32}."""
    now = t.params
    return {n: (now[n].float().cpu() - before[n])
            for n in now if n not in t._stateful}


def _host_tree(tree):
    return {k: _host_tree(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree.detach().cpu().clone()


def _load_live(torch, t, state):
    """Copy `state` ({params, opt}) into the live tensors of a one-replica
    trainer, which are those its `params` and `opt_state` return and
    its captured step reads (assigning them would drop the program)."""
    def walk(live, want):
        if isinstance(live, dict):
            for k in live:
                walk(live[k], want[k])
        else:
            live.copy_(want)
    with torch.no_grad():
        walk(t.params, state["params"])
        walk(t.opt_state, state["opt"])


def _sharded_run(torch, mx, net, mesh, x, y, planted=None, start=None,
                 zero=2, device=None, steps=2):
    """`steps` f32 steps of `net` at `zero` over `mesh` (or, in a process
    group, as this rank on `device`): per step the loss, the
    parameters' changes (the gradient proxies: -lr (g + wd w) + momentum
    m) and the running statistics after it, the state it started from,
    and how it ran ([eager, captured, replayed] steps).  `start`: a
    reference run whose state each step starts from, so that every step
    is compared from the same parameters and momentum; a one-replica
    trainer takes it into its live tensors, so that its steps run
    eager, then captured, then replayed.  `planted`: "rescale" leaves
    the update's rescale at the per-replica batch, "momentum" drops the
    momentum state before every step from the second."""
    from incubator_mxnet_tpu_torch import parallel
    t = parallel.ShardedTrainer(net, mesh=mesh, zero=zero, device=device,
                                **SHARDED_SGD)
    if planted == "rescale":
        for h in t._hyper:
            h[2].fill_(1.0)
    out = []
    for step in range(steps):
        if start is not None and t._capture:
            _load_live(torch, t, start[step]["state"])
        elif start is not None:
            t.params = start[step]["state"]["params"]
            t.opt_state = start[step]["state"]["opt"]
        if planted == "momentum" and step >= 1:
            for tree in t._opt:
                for leaf in tree.values():
                    leaf.zero_()
        state = dict(params=_host_tree(t.params), opt=_host_tree(t.opt_state))
        before = {n: v.float() for n, v in state["params"].items()}
        counts = (t.eager_steps, t.captures, t.replays)
        loss = float(t.step(x, y))
        params = t.params
        out.append(dict(loss=loss, deltas=_sharded_deltas(torch, t, before),
                        running={n: params[n].float().cpu().clone()
                                 for n in t._stateful}, state=state,
                        ran=[b - a for a, b in zip(counts, (
                            t.eager_steps, t.captures, t.replays))]))
    t.release()
    return out


def _sharded_captured_parity(torch, mx, net, cpu_net, x, y):
    """The program `train_sharded` times: one replica on cuda:0 at zero
    0, its steps eager, then captured, then replayed, in f32 at batch 4
    against the same trainer on the CPU (`device="cpu"`), each step from
    the CPU run's state, by `_sharded_parity`'s spread rule.  The
    momentum dropped before the captured and the replayed step must fail
    it at each of them."""
    kw = dict(zero=0, steps=SHARDED_SWEEP_STEPS)
    ref = _sharded_run(torch, mx, cpu_net, None, x, y, device="cpu", **kw)
    spread = _sharded_run(torch, mx, cpu_net, None, x * (1.0 + 2.0 ** -22),
                          y, start=ref, device="cpu", **kw)
    card = _sharded_run(torch, mx, net, None, x.cuda(), y.cuda(),
                        start=ref, device="cuda:0", **kw)
    planted = _sharded_run(torch, mx, net, None, x.cuda(), y.cuda(),
                           start=ref, device="cuda:0", planted="momentum",
                           **kw)
    steps = [_spread_parity(torch, card[i][what], ref[i][what],
                            spread[i][what])
             for i in range(len(card)) for what in ("deltas", "running")]
    dropped = [_spread_parity(torch, planted[i]["deltas"], ref[i]["deltas"],
                              spread[i]["deltas"])["grad_err_over_scale_max"]
               for i in (1, 2)]
    losses = dict(card=[r["loss"] for r in card],
                  cpu=[r["loss"] for r in ref])
    out = dict(zero=0, mesh=["cuda:0"], ran=[r["ran"] for r in card],
               losses=losses, loss_max_abs_err=max(
                   abs(a - b) for a, b in zip(losses["card"],
                                              losses["cpu"])),
               checks=["step%d %s" % (i + 1, what)
                       for i in range(len(card))
                       for what in ("deltas", "running")], steps=steps,
               planted_momentum_worst=dropped,
               planted_refused=all(
                   v["card"] > RESNET_SPREAD_FACTOR * max(v["cpu_spread"],
                                                          1e-6)
                   for v in dropped))
    _check(out["ran"] == [[1, 0, 0], [0, 1, 0], [0, 0, 1]],
           "sharded captured parity: the card's steps did not run eager, "
           "captured, replayed: %r" % (out["ran"],))
    _check(out["loss_max_abs_err"] <= SERVE_TOL, "sharded captured "
           "parity: the loss differs from the CPU trainer's by %g > %g"
           % (out["loss_max_abs_err"], SERVE_TOL))
    for name, s in zip(out["checks"], steps):
        _spread_checks("sharded captured parity " + name, s)
    _check(out["planted_refused"], "sharded captured parity: the momentum "
           "dropped before the captured or the replayed step passed: %r"
           % (dropped,))
    return out


def _sharded_parity(torch, mx, cs):
    """Two f32 batch-4 zero-2 steps on a 2-replica mesh on the card (both
    replicas on cuda:0, so the rescale across replicas shows) against
    the same trainer on CPU replicas cpu(0), cpu(1), each step from the
    CPU run's state: the losses, and each step's parameter changes and
    running statistics by train_resnet's spread rule (the CPU run's own
    spread under a 2**-22 change of its input; at 2 rows a replica the
    BatchNorms make both no smooth function of the input).  The update's
    rescale left at the per-replica batch, and the momentum dropped at
    step 2, must each fail it.  Then the one-replica captured step on
    the same batch (`_sharded_captured_parity`)."""
    from incubator_mxnet_tpu_torch import parallel
    rs = np.random.RandomState(2)
    x = torch.from_numpy(rs.randn(SHARDED_PARITY_BATCH, 3, 224, 224)
                         .astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 1000, SHARDED_PARITY_BATCH)
                         .astype(np.int64))
    net = _sharded_net(torch, mx, "cuda:0")
    cpu_net = _sharded_net(torch, mx, "cpu")
    _copy_to_cpu(mx, net, cpu_net, x[:1])
    card_mesh = parallel.make_mesh(devices=["cuda:0", "cuda:0"])
    cpu_mesh = parallel.make_mesh(devices=[mx.cpu(0), mx.cpu(1)])
    ref = _sharded_run(torch, mx, cpu_net, cpu_mesh, x, y)
    spread = _sharded_run(torch, mx, cpu_net, cpu_mesh,
                          x * (1.0 + 2.0 ** -22), y, start=ref)
    runs = {p: _sharded_run(torch, mx, net, card_mesh, x.cuda(), y.cuda(),
                            planted=p, start=ref)
            for p in (None, "rescale", "momentum")}

    def judged(run):
        steps = [_spread_parity(torch, run[i][what], ref[i][what],
                                spread[i][what])
                 for i in range(2) for what in ("deltas", "running")]
        ok = all(v["card"] <= RESNET_SPREAD_FACTOR * max(v["cpu_spread"],
                                                         1e-6)
                 for s in steps for v in (s["grad_err_over_scale_max"],
                                          s["grad_err_over_scale_median"]))
        return steps, ok
    good, good_ok = judged(runs[None])
    losses = dict(card=[r["loss"] for r in runs[None]],
                  cpu=[r["loss"] for r in ref])
    loss_err = max(abs(a - b) for a, b in zip(losses["card"], losses["cpu"]))
    planted = {p: judged(runs[p]) for p in ("rescale", "momentum")}
    out = dict(batch=SHARDED_PARITY_BATCH, dtype="float32", zero=2,
               card_mesh=["cuda:0", "cuda:0"], cpu_mesh=["cpu", "cpu:1"],
               losses=losses, loss_max_abs_err=loss_err,
               checks=["step1 deltas", "step1 running", "step2 deltas",
                       "step2 running"], steps=good,
               planted_refused={p: not v[1] for p, v in planted.items()},
               planted_worst={p: [s["grad_err_over_scale_max"]
                                  for s in v[0]]
                              for p, v in planted.items()})
    _emit(dict(phase="train_sharded_parity", **out))
    _check(loss_err <= SERVE_TOL, "sharded parity: the loss differs from "
           "the CPU replicas' by %g > %g" % (loss_err, SERVE_TOL))
    for name, s in zip(out["checks"], good):
        _spread_checks("sharded parity " + name, s)
    _check(good_ok, "sharded parity: %r" % (good,))
    for p, (_, ok) in planted.items():
        _check(not ok, "sharded parity: the planted %s fault passed" % p)
    out["captured"] = _sharded_captured_parity(torch, mx, net, cpu_net, x, y)
    _emit(dict(phase="train_sharded_captured_parity", **out["captured"]))
    del net, cpu_net
    return out


def _sharded_sweep(torch, mx, batch):
    """zero 0..3 on the one-card mesh from the same start: the losses of
    SHARDED_SWEEP_STEPS steps bit for bit (deterministic cuDNN)."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    x, y = _sharded_batch(torch, batch)
    losses = {}
    try:
        for zero in range(4):
            net = _sharded_net(torch, mx, "cuda:0")
            t = _sharded_trainer(torch, mx, net, zero=zero)
            losses[zero] = [t.step(x, y) for _ in range(SHARDED_SWEEP_STEPS)]
            losses[zero] = [v.float().item() for v in losses[zero]]
            t.release()
            del t, net
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = prev
    same = all(_same_bits(torch, torch.tensor(losses[z]),
                          torch.tensor(losses[0])) for z in losses)
    _check(same, "zero levels disagree on one card: %r" % (losses,))
    return dict(steps=SHARDED_SWEEP_STEPS, batch=batch, losses=losses,
                bit_identical=same)


def phase_train_sharded(torch, mx, cs):
    """bench.py's `sharded` config through parallel.ShardedTrainer on the
    one-card mesh (module doc, 13o); returns the conv kernel's launches
    over the path and a replayed step's by the profiler."""
    phase_t0 = time.perf_counter()
    parity = _sharded_parity(torch, mx, cs)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = _sharded_net(torch, mx, "cuda:0")
    cs.conv1x1_stats_launches = 0       # the main path starts here
    batch, t, x, y, warm = _sharded_fit(torch, mx, net)
    warm_counts = dict(captures=t.captures, replays=t.replays,
                       eager_steps=t.eager_steps)
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(SHARDED_STEPS + 1)]
    losses = []
    t0 = time.perf_counter()
    events[0].record()
    for i in range(SHARDED_STEPS):
        losses.append(t.step(x, y))
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cs.conv1x1_stats_launches    # the main path ends here
    timed = dict(captures=t.captures - warm_counts["captures"],
                 replays=t.replays - warm_counts["replays"],
                 eager_steps=t.eager_steps - warm_counts["eager_steps"])
    step_ms = [events[i].elapsed_time(events[i + 1])
               for i in range(SHARDED_STEPS)]
    losses = [v.item() for v in warm + losses]
    per_step = _profile(torch, lambda: t.step(x, y), 1, top=12,
                        phase="train_sharded_profile", batch=batch)
    conv = _profiled_counts(per_step)[3]
    peak = torch.cuda.max_memory_allocated()
    replica_bytes = t.replica_param_bytes()
    t.release()
    del t, net
    torch.cuda.empty_cache()
    sweep = _sharded_sweep(torch, mx, batch)
    _emit(dict(phase="train_sharded", model="resnet50_v1b", classes=1000,
               image=[3, 224, 224], dtype="bfloat16 (BatchNorm f32)",
               batch=batch, ladder=list(SHARDED_BATCHES),
               mesh=["cuda:0"], zero=0, **SHARDED_SGD,
               warmup_steps=SHARDED_WARMUP, steps=SHARDED_STEPS,
               images_per_s=SHARDED_STEPS * batch / wall, wall_s=wall,
               step_ms=step_ms, step_ms_median=statistics.median(step_ms),
               max_memory_allocated=peak, replica_param_bytes=replica_bytes,
               warmup=warm_counts, timed=timed, losses=losses,
               conv1x1_stats_launches=launches,
               conv_launches_per_replayed_step=conv,
               zero_sweep=sweep, parity=parity, phase_s=time.perf_counter() - phase_t0))
    _check(all(math.isfinite(v) for v in losses),
           "non-finite sharded loss: %r" % (losses,))
    _check(warm_counts == dict(captures=1, replays=0, eager_steps=1),
           "the warm-up steps did not run eager then capture: %r"
           % (warm_counts,))
    _check(timed == dict(captures=0, replays=SHARDED_STEPS, eager_steps=0),
           "timed sharded steps did not only replay: %r" % (timed,))
    _check(launches == 2 * RESNET_SITES, "the warm-up steps launched the "
           "conv kernel %d times, not %d" % (launches, 2 * RESNET_SITES))
    _check(conv == RESNET_SITES, "a replayed sharded step launched the conv "
           "kernel %d times by name, not %d" % (conv, RESNET_SITES))
    return dict(launches=launches, per_replayed_step=conv, batch=batch)


def _kv_loop(torch, mx, kvstore, update_on_kvstore=None):
    """resnet18_v1 as a Gluon user trains it on [gpu(0)]: split_and_load,
    a recorded forward per context, Trainer(kvstore=...); the parameters
    after KV_STEPS steps (CPU copies) and the trainer."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    mx.random.seed(0)
    ctx = [mx.gpu(0)]
    net = get_model("resnet18_v1", classes=1000)
    net.initialize(mx.init.MSRAPrelu(), ctx=ctx)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", dict(KV_SGD),
                          kvstore=kvstore,
                          update_on_kvstore=update_on_kvstore)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    rs = np.random.RandomState(3)
    for _ in range(KV_STEPS):
        x = rs.randn(KV_BATCH, 3, 224, 224).astype(np.float32)
        y = rs.randint(0, 1000, KV_BATCH).astype(np.float32)
        data = mx.gluon.utils.split_and_load(x, ctx)
        label = mx.gluon.utils.split_and_load(y, ctx)
        with mx.autograd.record():
            losses = [loss_fn(net(d), l) for d, l in zip(data, label)]
        mx.autograd.backward(losses)
        tr.step(KV_BATCH)
    params = {k: p.detach().cpu().clone()
              for k, p in net.collect_params().items()}
    return params, tr


def _kv_card_ops(torch, mx):
    """row_sparse_pull of card tensors and 2-bit compression of card
    gradients (a dist store on the NCCL group) against the same on the
    CPU, exactly."""
    from incubator_mxnet_tpu_torch import kvstore
    rs = np.random.RandomState(4)
    w = rs.randn(1000, 64).astype(np.float32)
    rows = np.array([3, 17, 999, 500, 3], np.int32)
    got = {}
    for dev in ("cuda:0", "cpu"):
        kv = kvstore.create("local")
        kv.init("emb", mx.nd.array(w, ctx=dev))
        out = mx.nd.zeros((1000, 64), ctx=dev)
        kv.row_sparse_pull("emb", out=out, row_ids=mx.nd.array(
            rows, dtype="int32", ctx=dev))
        dkv = kvstore.create("dist_sync")
        dkv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        dkv.init(0, mx.nd.zeros((257, 33), ctx=dev))
        pulled = []
        for i in range(3):
            g = np.random.RandomState(10 + i).randn(257, 33).astype(
                np.float32) * 0.6
            dkv.push(0, mx.nd.array(g, ctx=dev))
            o = mx.nd.zeros((257, 33), ctx=dev)
            dkv.pull(0, out=o)
            pulled.append(o.asnumpy())
        got[dev] = (out.asnumpy(), pulled, dkv.num_workers)
    same_rows = np.array_equal(got["cuda:0"][0], got["cpu"][0])
    same_2bit = all(np.array_equal(a, b) for a, b in zip(got["cuda:0"][1],
                                                         got["cpu"][1]))
    _check(same_rows, "row_sparse_pull on the card differs from the CPU's")
    _check(same_2bit, "2-bit compression on the card differs from the CPU's")
    return dict(row_sparse_pull_exact=same_rows, two_bit_exact=same_2bit,
                dist_workers=got["cuda:0"][2])


def phase_kvstore(torch, mx):
    """The Gluon multi-device loop and the KVStore on the card (module
    doc, 13p)."""
    import socket
    import torch.distributed as dist
    # the loops are held bit for bit: cuDNN's deterministic algorithms
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _kv_phase(torch, mx, socket, dist)
    finally:
        torch.backends.cudnn.deterministic = prev


def _kv_phase(torch, mx, socket, dist):
    phase_t0 = time.perf_counter()
    base, _ = _kv_loop(torch, mx, None)
    device, tr = _kv_loop(torch, mx, "device")
    device_store = tr._kvstore is not None
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method="tcp://127.0.0.1:%d" % port,
                            world_size=1, rank=0)
    try:
        dist_params, dtr = _kv_loop(torch, mx, "dist_sync")
        uok_params, utr = _kv_loop(torch, mx, "dist_sync",
                                   update_on_kvstore=True)
        card_ops = _kv_card_ops(torch, mx)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    same = {name: all(_same_bits(torch, p[k], base[k]) for k in base)
            for name, p in (("device", device), ("dist_sync", dist_params),
                            ("update_on_kvstore", uok_params))}
    uok_err = _scaled_err(uok_params, base)
    _emit(dict(phase="kvstore", model="resnet18_v1", batch=KV_BATCH,
               steps=KV_STEPS, ctx=["cuda:0"], sgd=KV_SGD,
               device_store_made=device_store,
               dist_backend=backend, dist_workers=dtr._kvstore.num_workers,
               bit_identical_to_kvstore_none=same,
               update_on_kvstore_worst_err_over_scale=max(uok_err.values()),
               card_ops=card_ops, phase_s=time.perf_counter() - phase_t0))
    _check(same["device"] and same["dist_sync"], "the kvstore's loops "
           "differ from kvstore=None: %r" % (same,))
    _check(same["update_on_kvstore"], "update_on_kvstore: the store's "
           "update is %g of scale off the Trainer's" % max(uok_err.values()))
    return same

# multi_card: the replica group across cards, where the host has them
MULTI_CARDS = 4
MULTI_ROWS = 8              # rows a replica
MULTI_TIMEOUT_S = 600


def _multi_batch(torch, n):
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(MULTI_ROWS * n, 3, 224, 224)
                         .astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 1000, MULTI_ROWS * n)
                         .astype(np.int64))
    return x, y


def _dist_worker(out_dir, zero):
    """One rank of `phase_multi_card`'s process group (started by the
    port's launcher, one card a rank, NCCL for card tensors): its rows
    of `_multi_batch` through two f32 steps of `ShardedTrainer` from the
    state the parent wrote; rank 0 writes what `_sharded_run` returns."""
    import torch
    import torch.distributed as dist
    import incubator_mxnet_tpu_torch as mx
    mx.base.ensure_distributed()
    rank, n = dist.get_rank(), dist.get_world_size()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda:%d" % torch.cuda.current_device()
    net = _sharded_net(torch, mx, dev)
    net.load_state_dict(torch.load(os.path.join(out_dir, "start.pt"),
                                   map_location=dev, weights_only=True))
    start = torch.load(os.path.join(out_dir, "ref%s.pt" % zero),
                       weights_only=True)
    x, y = _multi_batch(torch, n)
    rows = slice(rank * MULTI_ROWS, (rank + 1) * MULTI_ROWS)
    run = _sharded_run(torch, mx, net, None, x[rows].to(dev),
                       y[rows].to(dev), start=start, zero=int(zero),
                       device=dev)
    if rank == 0:
        torch.save([{k: v for k, v in r.items() if k != "state"}
                    for r in run], os.path.join(out_dir, "dist%s.pt" % zero))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_multi_card(torch, mx):
    """The replica group across cards (NCCL), where the host has at
    least two: `ShardedTrainer` at zero 0 (BatchNorm statistics summed
    across the cards in lockstep) and zero 2 (reduce-scatter, local
    statistics) on a mesh of up to MULTI_CARDS cards in one process,
    against the same replicas on one card (MULTI_ROWS rows each), and as
    one rank per card in a `torch.distributed` NCCL group started by the
    port's launcher; then the Gluon loop over the cards against the
    same loop on as many CPU replica contexts.  Each by the spread
    rule (two steps from the reference's state; the spread under a
    2**-22 change of the reference's input).  With one card it prints
    what was not shown."""
    from incubator_mxnet_tpu_torch import parallel
    from incubator_mxnet_tpu_torch.tools import launch
    cards = torch.cuda.device_count()
    if cards < 2:
        _emit({"multi_card": "not run", "cards": cards})
        return None
    phase_t0 = time.perf_counter()
    n = min(cards, MULTI_CARDS)
    devs = ["cuda:%d" % i for i in range(n)]
    x, y = _multi_batch(torch, n)
    net = _sharded_net(torch, mx, "cuda:0")
    out = dict(phase="multi_card", cards=cards, replicas=n,
               rows_per_replica=MULTI_ROWS)
    tmp = tempfile.mkdtemp(prefix="mxt-multi-")
    try:
        torch.save({k: v.cpu() for k, v in net.state_dict().items()},
                   os.path.join(tmp, "start.pt"))
        checks = []
        for zero in (0, 2):
            one = parallel.make_mesh(devices=["cuda:0"] if zero == 0
                                     else ["cuda:0"] * n)
            ref = _sharded_run(torch, mx, net, one, x.cuda(), y.cuda(),
                               zero=zero)
            spread = _sharded_run(torch, mx, net, one,
                                  x.cuda() * (1.0 + 2.0 ** -22), y.cuda(),
                                  start=ref, zero=zero)
            multi = _sharded_run(torch, mx, net,
                                 parallel.make_mesh(devices=devs),
                                 x.cuda(), y.cuda(), start=ref, zero=zero)
            torch.save([dict(state=r["state"]) for r in ref],
                       os.path.join(tmp, "ref%d.pt" % zero))
            with open(os.path.join(tmp, "log%d" % zero), "w") as log:
                rc = launch.launch(n, [sys.executable, os.path.abspath(
                    __file__), "dist-worker", tmp, str(zero)],
                    timeout=MULTI_TIMEOUT_S, out=log)
            _check(rc == 0, "the %d-rank NCCL group failed (rc %d): %s"
                   % (n, rc, open(os.path.join(tmp, "log%d" % zero))
                      .read()[-3000:]))
            dist = torch.load(os.path.join(tmp, "dist%d.pt" % zero),
                              weights_only=False)
            for name, run in (("one_process", multi),
                              ("process_group", dist)):
                for i in range(2):
                    for what in ("deltas", "running"):
                        checks.append(("zero%d %s step%d %s" % (
                            zero, name, i + 1, what), _spread_parity(
                                torch, run[i][what], ref[i][what],
                                spread[i][what])))
                out["zero%d_%s_losses" % (zero, name)] = [
                    r["loss"] for r in run]
            out["zero%d_reference_losses" % zero] = [r["loss"] for r in ref]
        out["sharded"] = {k: dict(max=v["grad_err_over_scale_max"],
                                  median=v["grad_err_over_scale_median"])
                          for k, v in checks}
        out["gluon"] = _multi_gluon(torch, mx, n)
        out["phase_s"] = time.perf_counter() - phase_t0
        _emit(out)
        for name, parity in checks:
            _spread_checks("multi_card " + name, parity)
        _spread_checks("multi_card gluon", out["gluon"]["parity"])
        _check(out["gluon"]["copies_equal"], "the Gluon loop's copies "
               "differ across the cards after a step")
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _multi_gluon_step(torch, mx, ctx, start, scale=1.0):
    """resnet18_v1's Gluon loop over the contexts `ctx` (kvstore
    "device"), one f32 step of MULTI_ROWS rows a context from the
    parameter file `start`: {trainable name: its change}."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    net = get_model("resnet18_v1", classes=1000)
    net.initialize(ctx=ctx)
    net.load_parameters(start, ctx=ctx)
    before = {k: p.detach().cpu().clone()
              for k, p in net.collect_params().items() if p.requires_grad}
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", dict(KV_SGD),
                          kvstore="device")
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = _multi_batch(torch, len(ctx))
    data = mx.gluon.utils.split_and_load(x * scale, ctx)
    label = mx.gluon.utils.split_and_load(y.float(), ctx)
    with mx.autograd.record():
        losses = [loss_fn(net(d), l) for d, l in zip(data, label)]
    mx.autograd.backward(losses)
    tr.step(x.shape[0])
    params = net.collect_params()
    same = all(torch.equal(c.cpu(), params[k].detach().cpu())
               for k in before for c in params[k].list_data())
    return {k: params[k].detach().cpu() - v for k, v in before.items()}, \
        same


def _multi_gluon(torch, mx, n):
    """The Gluon loop over n cards against the same loop over n CPU
    replica contexts, one step's parameter changes by the spread rule;
    every card's copy equal after it."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    tmp = tempfile.mkdtemp(prefix="mxt-gluon-")
    try:
        mx.random.seed(0)
        net = get_model("resnet18_v1", classes=1000)
        net.initialize(mx.init.MSRAPrelu(), ctx="cpu")
        with mx.autograd.pause():
            net(torch.zeros(1, 3, 224, 224))
        start = os.path.join(tmp, "start.params")
        net.save_parameters(start)
        cards, same = _multi_gluon_step(torch, mx,
                                        [mx.gpu(i) for i in range(n)], start)
        cpus = [mx.cpu(i) for i in range(n)]
        ref, _ = _multi_gluon_step(torch, mx, cpus, start)
        spread, _ = _multi_gluon_step(torch, mx, cpus, start,
                                      scale=1.0 + 2.0 ** -22)
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(contexts=n, copies_equal=same,
                parity=_spread_parity(torch, cards, ref, spread))

def setup(torch):
    """What every run of the phases starts from, here and in
    `tools/chip_phases.py`: f32 products without TF32, the card's env
    line, and every kernel built from the checkout (the build line with
    the ptxas report).  Returns the card's name and nvidia-smi's line."""
    from incubator_mxnet_tpu_torch.ops import _kernels

    # f32 products stay full f32 on the card (no TF32), so the kernel and
    # the served logits can be held to f32 tolerances
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = _nvidia_smi()
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    _emit(dict(phase="env", nvidia_smi=smi, device=name,
               capability=list(cap), torch=torch.__version__,
               cuda=torch.version.cuda))
    _check(cap == (9, 0), "needs a Hopper card (capability 9.0), got %s"
           % (cap,))

    t0 = time.monotonic()
    reports = _kernels.build_all()
    ptxas = _ptxas(reports)
    _emit(dict(phase="build", seconds=time.monotonic() - t0,
               kernels=sorted(_kernels.SOURCES), built=sorted(reports),
               spill_store_bytes=sum(k.get("spill_store_bytes", 0)
                                     for k in ptxas.values()),
               ptxas=ptxas))
    return name, smi


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.ops import attention as att
    from incubator_mxnet_tpu_torch.ops import conv_stats as cs
    name, smi = setup(torch)

    fwd_rows = phase_kernel(torch, att)
    main_row = fwd_rows[BERT_CASE]
    launches, replayed = phase_serve(torch, mx, att)
    bwd_rows = phase_kernel_bwd(torch, att)
    bwd_row = bwd_rows[BERT_CASE]
    train_launches = phase_train(torch, mx, att)
    bf16_launches = phase_train_bf16(torch, mx, att)
    conv_steps = phase_kernel_conv(torch, cs)
    conv_step = conv_steps["resnet"]
    resnet_row = phase_train_resnet(torch, mx, cs)
    conv_launches = resnet_row["launches"]
    gluon_launches = phase_train_resnet_gluon(torch, mx, cs, resnet_row)
    fed = phase_train_resnet_fed(torch, mx, cs)
    nmt_launches = phase_train_nmt(torch, mx, att)
    phase_decode_nmt(torch, mx, att)
    phase_generate_nmt(torch, mx, att, cs)
    registry_launches = phase_serve_registry(torch, mx, att)
    _serving_retired(torch)
    hyb = phase_hybridize_all(torch, mx, att, cs)
    nd_launches = phase_ndarray(torch, mx, att)
    nms_rows = phase_kernel_nms(torch)
    ssd = phase_train_ssd(torch, mx, att, cs)
    rcnn = phase_train_rcnn(torch, mx, att, cs)
    lamb = phase_train_lamb(torch, mx, att, cs)
    phase_optimizers(torch, mx)
    mobilenet = phase_train_mobilenet(torch, mx, att, cs)
    zoo_launches = phase_zoo(torch, mx, cs)
    phase_layers(torch, mx)
    phase_train_gnmt(torch, mx, att, cs)
    phase_generate_seq2seq(torch, mx, att, cs)
    phase_rnn(torch, mx)
    phase_train_wide_deep(torch, mx, att, cs)
    sharded = phase_train_sharded(torch, mx, cs)
    phase_kvstore(torch, mx)
    phase_multi_card(torch, mx)

    def nmt(kernel):
        """A flash row's NMT-path and bf16-path launches and their shapes'
        times."""
        return dict(nmt_launches=dict(total=nmt_launches[kernel],
                                      causal=nmt_launches[kernel + "_causal"]),
                    nmt_shape=_shape_rows(fwd_rows, bwd_rows, kernel,
                                          NMT_CASES),
                    bf16_launches=bf16_launches[kernel],
                    bf16_shape=_shape_rows(fwd_rows, bwd_rows, kernel,
                                           BF16_CASES)["non_causal"],
                    hybridized_launches_per_step=dict(
                        {p: hyb[p]["profiled_launches_per_step"][kernel]
                         for p in ("train_bf16", "train_nmt")},
                        train_lamb=lamb["flash_launches_per_replayed_step"][
                            kernel]),
                    nd_launches=nd_launches[kernel])
    shape = dict(shape=[main_row["BH"], main_row["T"], main_row["d"]],
                 dtype=main_row["dtype"])
    bwd_src = "incubator_mxnet_tpu_torch/ops/csrc/flash_attention_bwd.cu"
    _emit({"kernels": [
        dict(name="flash_attention_fwd", route="cuda",
             source="incubator_mxnet_tpu_torch/ops/csrc/"
                    "flash_attention_fwd.cu",
             replaces="incubator_mxnet_tpu/ops/attention.py:131",
             launches=launches, train_launches=train_launches["fwd"],
             serve_registry_launches=registry_launches,
             replayed_serving_batch_launches=replayed,
             parity="ok",
             max_abs_err=max(main_row["err_out"], main_row["err_lse"]),
             ms=main_row["ms"], kernel_ms=main_row["ms"],
             plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"],
             bound_by=main_row["bound_by"],
             library_ms=main_row["library_ms"], **shape, **nmt("fwd")),
        dict(name="flash_attention_bwd_dq", route="cuda", source=bwd_src,
             replaces="incubator_mxnet_tpu/ops/attention.py:232",
             launches=train_launches["dq"], parity="ok",
             max_abs_err=max(bwd_row["err"]["dq"], bwd_row["err_delta"]),
             ms=bwd_row["dq_ms"], kernel_ms=bwd_row["dq_ms"],
             plain_ms=bwd_row["dq_plain_ms"],
             bound_ms=bwd_row["dq_bound_ms"],
             bound_by=bwd_row["dq_bound_by"],
             library_ms=bwd_row["library_ms"],
             library_events_ms=bwd_row["library_events_ms"],
             library_kernel=bwd_row["library_kernels"][0]["kernel"],
             **shape, **nmt("dq")),
        dict(name="flash_attention_bwd_dkv", route="cuda", source=bwd_src,
             replaces="incubator_mxnet_tpu/ops/attention.py:278",
             launches=train_launches["dkv"], parity="ok",
             max_abs_err=max(bwd_row["err"]["dk"], bwd_row["err"]["dv"]),
             ms=bwd_row["dkv_ms"], kernel_ms=bwd_row["dkv_ms"],
             plain_ms=bwd_row["dkv_plain_ms"],
             bound_ms=bwd_row["dkv_bound_ms"],
             bound_by=bwd_row["dkv_bound_by"],
             library_ms=bwd_row["library_ms"],
             library_events_ms=bwd_row["library_events_ms"],
             library_kernel=bwd_row["library_kernels"][0]["kernel"],
             **shape, **nmt("dkv")),
        dict(name="conv1x1_stats", route="cuda",
             source="incubator_mxnet_tpu_torch/ops/csrc/conv1x1_stats.cu",
             replaces="tools/conv_stats_pallas_experiment.py:9",
             launches=conv_launches, gluon_launches=gluon_launches,
             fed_launches=fed["launches"],
             fed_launches_per_replayed_step=fed["per_replayed_step"],
             hybridized_launches_per_step=dict(
                 train_resnet_gluon=hyb["train_resnet_gluon"]
                 ["profiled_launches_per_step"]["conv"]),
             parity="ok",
             max_abs_err=conv_step["max_abs_err"], ms=conv_step["ms"],
             plain_ms=conv_step["plain_ms"], bound_ms=conv_step["bound_ms"],
             bound_by=conv_step["bound_by"],
             library_ms=conv_step["library_ms"],
             library_conv_ms=conv_step["library_conv_ms"],
             shape="the %d launch sites of one resnet50_v1b step, summed"
                   % RESNET_SITES, dtype="bfloat16", batch=RESNET_BATCH,
             train_rcnn_step={k: conv_steps["rcnn"][k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "max_abs_err", "launches", "paths")},
             train_rcnn_warmup_launches=rcnn["launches"]["conv"],
             train_rcnn_launches_per_step=rcnn["profiled_conv_per_step"],
             train_mobilenet_step={k: conv_steps["mobilenet"][k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "library_conv_ms", "max_abs_err", "launches", "paths")},
             train_mobilenet_launches_per_step=mobilenet[
                 "conv_launches_per_replayed_step"],
             train_mobilenet_device_ms_per_step=mobilenet[
                 "conv_device_ms_per_step"],
             zoo_launches_per_replayed_step=zoo_launches,
             train_sharded_launches=sharded["launches"],
             train_sharded_launches_per_replayed_step=sharded[
                 "per_replayed_step"],
             train_sharded_batch=sharded["batch"]),
        dict(name="nms", route="cuda",
             source="incubator_mxnet_tpu_torch/ops/csrc/nms.cu",
             replaces="no TPU kernel: box_nms "
                      "(incubator_mxnet_tpu/ops/contrib.py:59) and "
                      "_nms_keep (incubator_mxnet_tpu/ops/rcnn.py:58) are "
                      "XLA loops there",
             launches=ssd["launches"] + rcnn["launches"]["nms"],
             train_rcnn_warmup_launches=rcnn["launches"]["nms"],
             train_rcnn_launches_per_step=rcnn["profiled_nms_per_step"],
             detection_launches=ssd["detection_launches"],
             detection_ms=ssd["detection_ms"], parity="exact",
             max_abs_err=max(r["max_abs_err"] for r in nms_rows.values()),
             ms=nms_rows["proposal"]["ms"],
             plain_ms=nms_rows["proposal"]["plain_ms"],
             bound_ms=nms_rows["proposal"]["bound_ms"],
             bound_by=nms_rows["proposal"]["bound_by"],
             library_ms=None, shape=nms_rows["proposal"]["shape"],
             detection_bound_ms=ssd["detection_nms"]["bound_ms"],
             **{case + "_shape": {k: nms_rows[case][k] for k in (
                 "shape", "ms", "device_ms", "plain_ms", "bound_ms",
                 "bound_by", "scratch_bytes")} for case in (
                 "box_nms", "multibox_detection", "interleaved_flags",
                 "proposal_positions_only")})]})
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["dist-worker"]:
        sys.exit(_dist_worker(*sys.argv[2:]))
    sys.exit(main())
