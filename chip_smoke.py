#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mxtpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure raises and the script exits non-zero:

1. the card: its name, and name and power limit from nvidia-smi;
2. build the hand-written kernels from mxtpu_torch/csrc with nvcc, one
   process per source, all at once, and print ptxas's registers and
   spills (the bf16 dK/dV kernel's by head dim, the f32 flash kernels' at
   head dims 16, 32 and 128, and the LSTM/GRU cluster kernel's by kind,
   dtypes and rows a cluster, on lines of their own); the f32 dQ and
   dK/dV kernels must not spill at head dims 16 and 32;
3. hold each kernel against its plain PyTorch version on the card: the
   LSTM/GRU time loops (thread-block clusters) at the serving slice's
   shapes (T=32, H=200, N in {1, 32}; float32 and bfloat16) and at
   RNN_EXTRA_SHAPES (ragged unit slices at H=37, the streamed mode at
   H=512 in f32, ragged rows over clusters, T=1) and GL_LM_KERNEL_SHAPES
   (the Gluon LM at its example's widths: T=8, N=16, H=64; at PTB's it
   is the serving slice's shape), each launch's plan and
   how many of its clusters the card holds at once printed beside it,
   each called twice for the same bits; the three flash-attention
   kernels (forward with lse, dQ, dK/dV) at the training slice's shape
   (B=8, H=4, T=256, D=16, f32, causal), at the JAX package's own check
   shape (B=1, H=8, T=8192, D in {64, 128}, bf16, causal), on shard
   offsets that leave rows fully masked, and on lengths that are not a
   multiple of the tile (the last two in f32 at D=16, 32 and 128 and in
   bf16 at D=16 and 32), and in f32 at D=16 and 32 with keys past kv_len
   and with a shard offset whose causal limit falls inside a tile; a
   second call of each kernel must give the same bits; bf16 runs all
   three on the wgmma/TMA kernels
   (flash_fwd_sm90, flash_bwd_dq_sm90, flash_bwd_dkv_sm90), held to the
   allowance derived for their rounding of P and dS (SM90_*), and each
   call must launch the kernel its dtype routes to and no other; then
   the LSTM/GRU gradients under autograd (f32 and bf16, N in {1, 32})
   against the CPU's plain autograd, one kernel launch a forward and
   none a backward;
4. serving: a bucketed LSTM language model at the published widths of
   example/rnn/lstm_bucketing.py (vocab 10,000, embed 200, hidden 200,
   2 layers, 32 tokens), with weights drawn from --seed, checkpointed and
   served by InferenceEngine on cuda:0; every answer is checked against
   the same checkpoint served on the CPU (the plain path), and the LSTM
   kernel must have been launched once per layer per request;
5. the same model with mode="gru", which drives the GRU kernel;
6. training: the causal attention LM of
   example/long-context/ring_attention_lm.py (vocab 32, dim 64, 4 heads,
   sequence 256, batch 8, f32) trained on cuda:0 with the example's Adam
   for its 300 steps from --seed; attention goes through
   mxtpu_torch.parallel.local_attention, which picks the flash kernels.
   It must learn the copy task (nll < 0.5 ln 32), launch each flash
   kernel once per step, and match its first 3 steps run on the CPU (the
   plain path) in loss and parameters;
7. the op entry: mt.nd.flash_attention on the card launches the kernel;
   local_attention(impl="auto") takes the dense path on a problem the
   kernels refuse (head dim 80, float16) and flash on one they take
   (bf16, head dim 64), forward and backward against the CPU; and
   nd.SoftmaxOutput's backward (softmax - onehot, with grad_scale,
   normalization, use_ignore, smooth_alpha, multi_output and out_grad)
   on gpu(0) against the CPU;
8. the bf16 long-context path: mt.nd.flash_attention on bf16 NDArrays of
   (1, 8, 8192, 64) on gpu(0) launches flash_fwd_sm90 alone, and
   mxtpu_torch.parallel.local_attention(impl="auto", causal=True) forward
   and backward under autograd on bf16 (1, 8, 8192, 128) launches
   flash_fwd_sm90, flash_bwd_dq_sm90 and flash_bwd_dkv_sm90 once each
   and no f32 kernel; every output against the plain versions, within
   the derived allowance (SM90_*);
9. mx.rtc (mxtpu_torch.rtc, NVRTC): the six launch cases of the JAX
   package's rtc tests rewritten in CUDA C (axpy, fill_rows on
   blockIdx.x, dbl with its output first, rows on blockIdx.y, a scalar
   multiply over three alphas, rep with an int n) against their plain
   versions; one compile across new scalar values and shapes; a float64
   output behind float * comes back converted; half through
   cuda_fp16.h and 64 KB of dynamic shared memory work; a syntax error
   raises with NVRTC's log; a cpu() context raises;
10. the custom-op slice: the MLP of example/numpy-ops/custom_softmax.py
   at its own widths (784 -> 128 relu -> 10, batch 128, 2048 samples
   made as the example makes them, momentum SGD lr 0.1 / 0.9, 4 epochs =
   64 steps, f32), whose softmax-with-loss head is a CustomOp launching
   two CUDA C kernels compiled by mx.rtc (cs_softmax_fwd,
   cs_softmax_bwd). Each is held against its plain version at (128, 10)
   and at the LSTM LM's output rows (1024 x 10,000), and the forward also
   at the widths and alignments of its three paths; the MLP trains 64
   steps on cuda:0 through symbol.eval_graph under mxtpu_torch.autograd
   (first 3 steps against the CPU's plain route, one launch of each
   kernel a step, train accuracy > 0.9) and is served by
   InferenceEngine on cuda:0 (buckets 1-128) against the same weights
   served on the CPU;
11. Module.fit with the eager step (MXTPU_MODULE_FUSED=0): both
   examples' training calls through
   mx.mod.Module(...).fit(...) on the current context, gpu(0). The MLP as
   custom_softmax.py calls it (its seeds, NDArrayIter with shuffle, SGD
   lr 0.1 / momentum 0.9, 4 epochs; its head launches cs_softmax_fwd and
   cs_softmax_bwd once a step, cs_softmax_fwd once a scored batch; train
   accuracy by score > 0.9), its first 3 steps against the CPU's Module
   and against the hand-written cs_train loop from the same weights and
   batches; LeNet as train_mnist.py --network lenet calls it (a local
   kvstore object, Xavier, SGD lr 0.05 / momentum 0.9, Speedometer, the
   validation digits scored each epoch, 3 epochs on the example's 2,000
   synthetic digits), its first 3 steps against the CPU's Module, its
   validation accuracy >= LENET_MIN_ACC, its checkpoint loaded into a CPU
   Module scoring the same;
12. Module.fit captured (the fused train step, the default): the same MLP
   call and LeNet with fit's own kvstore="local" train through one CUDA
   graph a batch signature: each signature's first step runs for real and
   is captured, every later step replays. Their first 3 steps against the
   card's eager steps (CAPTURE_TOL) and the CPU's fused Module (FIT_TOL);
   whole fits against the eager fits of the same calls (FUSED_FIT_TOL;
   LeNet's both with cuDNN's deterministic algorithms);
   FUSED_COMPILES captures and a replay in every other step, no fallback;
   each MLP graph holds one cs_softmax_fwd and one cs_softmax_bwd node, so
   the head kernels run once a step; accuracy as in phase 11; no host wait
   in a steady-state epoch (torch's sync debug mode "error"); a custom op
   whose Python body reads the card (the example's numpy op) refuses the
   capture and the trainer falls back to the eager step once. Then each
   model's step, eager and captured in turns (ms, host time by phase, the
   card's busy share, kernels and host launch calls a step);
13. the bucketed LSTM LM of example/rnn/lstm_bucketing.py (BASELINE.json
   config 4) through mx.mod.BucketingModule(...).fit(...) on gpu(0), as
   lstm_bucketing_fit mirrors the example: lstm_scan and gru_scan against
   their plain versions at each bucket's length (T = 8, 16, 24, 32, N=32,
   H=200); the example's own run (synthetic_corpus(), vocabulary 64, embed
   and hidden 200, 2 layers, batch 32, buckets 8/16/24/32, Adam 0.01,
   Xavier, Perplexity(ignore_label=0), 5 epochs) with FusedRNNCell, then
   with LSTMCells, each captured: one compile and one graph a bucket, a
   replay at every later step, every bucket's executors on the fused
   group's parameter tensors, lstm_scan one node a layer in each
   FusedRNNCell graph (launches counted as the warm-up steps' own plus
   nodes x replays, from 0 just before the fit), the last epoch's
   perplexity below BL_PPL_DROP of the first's; FIT_STEPS steps of the
   FusedRNNCell model in bucket 32 captured against the same fused step uncaptured on the card
   (CAPTURE_TOL), the CPU's fused Module (FIT_TOL) and, with SGD, the
   card's eager step (CAPTURE_TOL): with SGD every weight, with Adam all
   but BL_ADAM_APART's few; each bucket's graph replayed out of capture
   order against the eager forward on the weights it starts from; the
   timed run at PTB's vocabulary (10,000; 2,000
   synthetic sentences), eager and captured in turns: ms a step by bucket,
   tokens/s, the card's busy share, graph nodes and pool bytes a bucket,
   no capture after warm-up, and where bucket 32's captured step spends
   its card time, from a trace of the trainer's own graph (forward with
   B4's launches, the head, the recompute backward, the rest of the
   backward, the update; each kernel node's part marked at its capture);
   then the GRU variant (gru_scan in every graph), 1
   epoch, below BL_GRU_PPL_SHARE of the vocabulary in perplexity;
14. the ResNet slice (BASELINE.json config 2):
   example/image-classification/train_imagenet.py --benchmark 1 through
   common/fit.py's Module.fit call, mirrored by imagenet_fit (the
   example imports mxtpu), with the context on gpu(0) where fit.py
   hard-codes cpu(). The first steps of ResNet-50 at 224 (batch 16, TF32
   off) on the card against the CPU's Module (RN_STEP_SHARE,
   RN_AUX_TOL), captured steps against eager ones on the card with
   cuDNN's deterministic algorithms (CAPTURE_TOL, weights and moving
   statistics); then the full-width run: ResNet-50 at 3x224x224, 1,000
   classes, batch 128, f32, an epoch cut to RN_STEPS steps, RN_EPOCHS
   epochs eager (fit.py's kvstore object) and captured
   (kvstore="local"; one capture a signature, a replay every later step,
   the 102 moving statistics updated inside the graph), under torch's
   default TF32 (cuDNN on, matmuls off): the fixed batch's training
   cross-entropy in the last epoch below RN_CE_SHARE of the first's, no
   host wait in a captured epoch, ms a step and images/s in turns of
   RN_TIMED_STEPS steps with the host time by phase, the card's busy
   share, kernels and host launch calls a step and the share of the
   step's bound (FLOPs counted by FlopCounterMode at TF32's or float32's
   peak); the checkpoint loaded into a CPU Module predicting as the card
   does; the same timings with TF32 off, each path fitted one epoch of
   RN_OFF_STEPS steps; then Inception-BN: its first steps against the CPU
   and a short captured epoch at batch 128;
15. the Gluon slice (BASELINE.json config 3): gluon.model_zoo.vision.
   resnet18_v1 (classes 1,000) with Xavier(gaussian, in, 2), trained by
   example/gluon/mnist.py's loop (autograd.record, loss.backward(),
   Trainer.step with fit.py's SGD 0.1 / 0.9 / wd 1e-4,
   SoftmaxCrossEntropyLoss) over a gluon DataLoader of an ArrayDataset of
   synthetic images from --seed, on gpu(0): the first step at batch 16
   (TF32 off) against the CPU per weight (RN_STEP_SHARE) and the moving
   statistics (RN_AUX_TOL), 3 steps within RN_SPREAD of the CPU's own
   spread from weights one ulp apart; GL_CAPTURE_STEPS hybridized steps
   (one compile, one capture of the forward and the backward at the
   second call, a replay at every later one) against eager ones under
   deterministic cuDNN (GL_HYB_TOL); the hybridized block called twice
   under one record() a step (a shared-weight pair) for GL_SHARED_STEPS
   steps against the eager block (GL_HYB_TOL), the second call of each
   step after the capture evaluating the traced graph uncaptured, since
   the graphs' activations await the first call's backward (counted);
   then 3x224x224 at batch 128, eager
   and hybridized, under torch's default TF32 and with TF32 off: the
   fixed data learnt (GL_CE_SHARE), ms a step and images/s in turns, the
   host time by phase (data loader, forward/backward, trainer.step), the
   card's busy share and launches a step, the share of the step's bound
   (FLOPs by FlopCounterMode), the graphs' pool. The Gluon word LM of
   example/gluon/word_language_model.py: its own run (vocabulary 40, 4
   epochs, the example's perplexity assertions), at PTB's widths
   (vocabulary 10,000, embed and hidden 200, 2 layers, bptt 32, batch
   32) its first 3 steps against the CPU and GL_LM_STEPS steps timed, and
   the GRU variant; lstm_scan (gru_scan) launched once a layer a forward,
   counted from 0 just before each run. The hybridized MLP of
   example/gluon/mnist.py: accuracy > GL_MNIST_ACC;
16. the CIFAR records slice: example/image-classification/
   train_cifar10.py --synthetic 5120 through common/fit.py's Module.fit
   call, mirrored by cifar_fit (the example imports mxtpu), on gpu(0).
   The example's records (28x28 JPEG, quality 95; 5,120 for training, 40
   steps an epoch, and 1,024 for validation) are written under a
   temporary directory and read by the port's ImageRecordIter with
   train_cifar10's level-2 augmentation (pad 4, fill 127, random crop and
   mirror, h/s/l jitter 36/50/50) on its pool of 4 spawned decode
   processes (the pool path is asserted, each pool's start-up printed).
   The iterator alone (fit.py's test-io loop): images/s beside the host's
   cores. ResNet-110 (bottleneck, 12 units a stage at 64/128/256) at
   3x28x28, 10 classes, batch 128, f32, SGD lr 0.05 / momentum 0.9 / wd
   1e-4, eager (fit.py's kvstore object) and captured (kvstore="local":
   one capture, a replay every later step) for CF_EPOCHS epochs under
   torch's default TF32, the validation records scored each epoch: the
   last 4 steps' cross-entropy below CF_CE_SHARE of the first 4's; after
   each fit its validation outputs equal an eager copy's given its
   weights and moving statistics (CF_EVAL_TOL); no host wait in a
   captured epoch; batches staged behind a sleep kernel with their
   pinned host memory dropped arrive intact, and the copy up timed from
   pinned and pageable memory; the steps timed in turns (ms, images/s, the
   host's wait for a batch, the card's busy share, launches a step, the
   bound from FlopCounterMode), with the captured step also repeated on
   one batch already on the card: whether the decoders or the card set
   the captured step's pace; the same timings with TF32 off (a captured
   fit of one epoch; the eager module of TF32 on times the eager step); a
   captured fit whose last batch is padded replays it; every fit reads
   one pair of decode pools;
17. the SSD slice (BASELINE.json config 5): multibox_nms (csrc/vision.cu,
   MultiBoxDetection's greedy NMS, one block an image) against its plain
   loop at SSD-300's 8,732 anchors and 21 classes, batch 1 and 8, on tied
   scores and with force_suppress (at its first NMS_CUT_ROWS anchors) and
   with nms_topk=400, each call twice for
   the same bits (class ids equal), and timed beside its bound; the
   MultiBox ops on cuda:0 against the CPU at batch 32 (cls_target equal);
   then, with the kernel's count from 0, example/ssd/train_ssd_toy.py's
   main (ssd_toy_main) on gpu(0), its first 3 steps against the CPU
   (SSD_TOY_TOL), its losses falling; and SSD-300 on VGG16-reduced
   (ssd300_vgg16, MXNet SSD's published config) at full width, batch 32,
   f32, from SSD_RECORDS synthetic 300x300 JPEG records through
   ImageDetIter (random crop, pad and mirror, mean/std), eager and
   hybridized for SSD_EPOCHS epochs each (the last 4 steps' loss below
   SSD_LOSS_SHARE of the first 4's), both timed in turns fed by the iterator and on one batch held on
   the card (ms, images/s, host ms by phase, busy share, launches, peak
   memory), the iterator alone, FLOPs and the bound with TF32 on and
   off, and a held-out image decoded on the kernel against the CPU's
   plain loop;
18. multi-output graphs and detection training: example/rcnn/
   train_rcnn_toy.py's main (rcnn_toy_main) on gpu(0) at its own widths
   (64 images of 32x32, batch 8, the 16/32-channel backbone, 8 epochs of
   Adam): the RPN Group of SoftmaxOutput(multi_output, use_ignore),
   MakeLoss(smooth_l1) and BlockGrad trained through simple_bind, then
   Proposal (its NMS on multibox_nms, counted from 0 just before the
   run: one launch for its one call), get_internals()["feat_output"],
   ROIPooling and the roi head; the example's three asserts, the first 3
   RPN steps against the CPU's (RCNN_TOL), the rois and pooled features
   against the CPU's Proposal and ROIPooling on the same inputs. 18b.
   Proposal at Faster R-CNN's size (600x1000, a 38x63 map at stride 16,
   28,728 anchors, 6,000 before the NMS, 300 after): its rois equal to
   the plain NMS loop's on the card, multibox_nms at that shape timed
   beside its bound;
19. example/python-howto/multiple_outputs.py on gpu(0) against the CPU,
   and example/multi-task/multitask_mnist.py's Module.fit (784 -> 128 ->
   {10, 2}, batch 128, 2,048 + 512 digits, Adam 1e-3, 4 epochs,
   MultiAccuracy, two labels): its first 3 steps, eager and fused,
   against the CPU's Module (MT_TOL); the fit eager and as fit makes it
   by default, both heads above MT_MIN_ACC, the fused trainer's
   captures, replays and fallbacks printed; the cost of MultiAccuracy's
   host reads against Accuracy summed on the card;
20. the data files at MNIST's published size (60,000 + 10,000 images,
   idx.gz written from --seed as example/utils/get_data.py writes them;
   CIFAR-10's 10,000 test images as its python pickle): LeNet through
   Module.fit fed by MNISTIter (batch 64, softmax_label), eager and
   captured, validation accuracy >= LENET_MIN_ACC; example/gluon/
   mnist.py's hybridized MLP fed by gluon.data.vision.MNIST with
   ToTensor and Normalize through a DataLoader (worker threads, samples
   on the host, one copy up a batch) for MN_GLUON_STEPS batches, test
   accuracy above MN_GLUON_MIN_ACC; for both, the iterator alone (the
   MLP's loader over MN_LOADER_BATCHES), the step fed against
   the step on a held batch, the host's wait for a batch, the card's
   busy share, and which side sets the pace; vision.CIFAR10 with
   RandomFlipLeftRight through a DataLoader alone; one epoch of CSVIter
   and LibSVMIter (CSR batches) staged on gpu(0), equal to the CPU's
   batches;
21. the op sweep on the card: every op the port registers (CARD_SWEEP,
   one row of inputs each; a CPU test holds the table to the registry)
   through mt.nd on gpu(0) against cpu() with TF32 off, its outputs and,
   where it is differentiable, its inputs' gradients within SWEEP_TOL;
   the count that passed and the names that failed are printed, and any
   failure fails the run (the random ops compare exactly: their draws
   are on the CPU generator either way). Then nd.contrib.box_nms, whose
   NMS on the card is the multibox_nms kernel, against the CPU's (the
   kernel's plain loop) at BOX_NMS_ROWS rows, plain, with topk and with
   force_suppress, its launches counted from 0 there, and its time at
   SSD-300's 8,732 rows;
22. the examples the sweep's ops open, each main mirrored (the examples
   import mxtpu) and run on gpu(0) to its own asserts: example/fcn-xs/
   fcn_toy.py (Deconvolution, Crop), svm_mnist.py (SVMOutput),
   nce-loss/nce_lm.py (batch_dot), neural-style/neural_style_toy.py
   (dot), kaggle-ndsb2/train_ndsb2.py (LogisticRegressionOutput through
   FeedForward, CSVIter and metric.np); each one's first 3 steps on the
   card against the CPU (EX_SHARE);
23. FCN-8s on VGG16 (get_fcn8s_symbol of MXNet's example/fcn-xs, Caffe's
   voc-fcn8s) at full width: 500x500, batch 1, 21 classes, f32, through
   Module.fit on gpu(0). Each Crop's window inside its map (offsets 5, 9,
   31); the first forward/backward at FCN_CHECK_HW against the CPU (TF32
   off, FCN_TOL); FCN_CAPTURE_STEPS captured steps against eager ones;
   FCN_EPOCHS epochs of FCN_IMAGES synthetic images (shapes whose class
   sets their colour, 255 on their edges) eager and captured under
   torch's default TF32 (the loss falls and the pixel accuracy rises);
   both steps timed in turns beside the bound from the layers' FLOPs,
   the card's busy share, the three Deconvolutions' card time forward
   and backward, the peak memory;
24. the examples cached_attention and moe_ffn open, mirrored (the
   examples import mxtpu) and run on gpu(0) at their own widths: each
   TRAIN symbol's first 3 fused Module.fit steps (captured) against the
   CPU's (EX_SHARE); a generation program that reads the card inside its
   capture raises; example/char_lm/char_lm.py's main through the fused
   Module.fit (perplexity < 1.35), its GEN checkpoint served by
   InferenceEngine.from_checkpoint and GenerateScheduler (the memorized
   text, the same tokens twice, no new program, every prefill and decode
   program a CUDA graph); example/moe_transformer/
   moe_transformer.py's train() on one device (perplexity < 2.5), its
   unsharded engine e0 against the CPU's (1e-5) and swap_weights building
   nothing;
25. full width: char_lm's build_lm at the ALiBi paper's WikiText-103
   widths (16 layers, d 1024, 8 heads, vocabulary 267,735, f32; cache
   1,024) served on gpu(0) (K = 32 slots, prefill buckets 32/128/512, 64
   sequences of prompts 16-512 tokens and WT_NEW new tokens through
   GenerateScheduler: tokens/s, TTFT and decode-step percentiles beside
   the step's bound, the step's busy share, captures before and after;
   TF32 off, and the first 16 tokens of 2 sequences against the CPU's);
   the first forward/backward at 2 layers and T=32 against the CPU
   (WT_TOL); 10 captured Module.fit steps at batch 8 x 512 with Adam and
   TF32 on beside the FLOPs bound, peak memory; moe_ffn at Switch-Base-8
   (d_model 768, d_ff 3,072, 8 experts, top-1, capacity factor 1.25, 4,096
   tokens) forward and backward against the CPU (the same routing,
   SWITCH_TOL) and its ms beside the einsums' bound;
26. fit.py's --optimizer nag --mom 0.9 --wd 1e-4 --initializer msra --top-k
   5 --loss ce,nll through train_imagenet.py --benchmark 1's fit call
   (imagenet_fit, fit.py's _select_initializer and _eval_metrics mirrored)
   at ResNet-50's width (224, batch 128, TF32 off): MSRAPrelu's deviation
   by its formula, 3 captured NAG steps equal to eager ones under
   deterministic cuDNN, the captured step timed beside phase 14's SGD step
   with update_metric's host ms, top-5 / CE / NLL against a host recompute;
27. every optimizer of the registry (16) through LeNet's Module.fit with
   its momentum, weight decay and clipping: 8 captured steps (5 replays
   past the capture) against 8 eager ones, the first eager step against
   the CPU's, SGLD by its noise's band; a line each, captured or eager
   and why;
28. RNN checkpoints on the bucketed LM at PTB's widths (FusedRNNCell, 3
   epochs, upstream's cudnn_lstm_bucketing.py recipe): do_rnn_checkpoint
   and the optimizer's states each epoch, lstm_scan counted from 0 just
   before the fit (one a layer a step), the last checkpoint scored through
   the unfused LSTMCells against the fused module, a run resumed at epoch
   1 against the one never stopped;
29. example/module/sequential_module.py, example/module/python_loss.py and
   example/python-howto/monitor_weights.py (mirrored) on gpu(0) to their
   asserts, and upstream MXNet's python_loss.py chain (a Module and a
   PythonLossModule in a SequentialModule) through fit;
30. example/ctc/ctc_toy.py (a FusedRNNCell LSTM and ctc_loss through
   Module.fit) and example/speech_recognition/deepspeech_toy.py (a
   bidirectional FusedRNNCell GRU and ctc_loss through BucketingModule),
   mirrored: their first 3 steps on gpu(0) against the CPU's (EX_SHARE),
   then each main on gpu(0) to its own asserts, lstm_scan / gru_scan
   counted from 0 just before each;
31. DeepSpeech 2 at its published widths (arch_deepspeech.py: 161 bins,
   two 32-channel convolutions, 3 bidirectional GRU layers of 1,760, 29
   symbols, batch 12, buckets 200 / 300 frames; 145M weights, f32, TF32
   off) through BucketingModule.fit with Adam: gru_scan at (T=100, N=12,
   H=1760), streamed, against its plain loop, its bound and cuDNN's GRU
   (one direction, and both);
   ctc_loss beside F.ctc_loss; the first step at batch 2 against the CPU;
   3 captured steps against eager ones; a captured fit (6 gru_scan
   launches a step, 6 nodes a bucket's graph, the loss falling below
   DS2_FALL of its start) and an eager one, each bucket's step timed
   beside its bound, the busy share (profiler, one replay of the first
   bucket's graph), the graphs and the peak memory;
32. the Gluon cells at the word LM's PTB widths: a hybridized
   SequentialRNNCell of two LSTMCells (GRUCells) given the fused layer's
   weights against the layer (lstm_scan / gru_scan): outputs, loss and
   gradients, 3 SGD steps each way, ms a step; a Conv2DLSTMCell learning
   and an LSTMPCell against the CPU;
33. remat: resnet18_v1 (224, batch 128, TF32 off) with its four residual
   stages hybridized with and without remat=True: the same gradients,
   weights and moving statistics, ms a step and the peak memory (lower
   with remat); MXNET_BACKWARD_DO_MIRROR=1 on LeNet's Module.fit, eager
   and captured, against without;
34. example/gluon's lstm_crf.py, super_resolution.py, actor_critic.py,
   kaggle_k_fold_cross_validation.py and learning_rate_manipulation.py,
   mirrored: their first 3 steps on gpu(0) against the CPU's (under Adam,
   step 1's gradients, and the weights but for GLUON_ADAM_APART entries
   each within 2 lr), then each main on gpu(0) to its own asserts;
35. what nd.random_normal opens (ROADMAP A1, A9): example/vae/
   vae_mnist.py's VAE at Kingma & Welling's MNIST widths (784-500-20,
   batch 100; arXiv:1312.6114 section 5), eager Gluon with
   nd.random_normal every step: its first 3 steps on gpu(0) against the
   CPU from the same weights and draws, then one epoch over phase 20's
   60,000 digits loaded once onto the card, the -ELBO falling, its ms a
   step and the draw's share of it; example/bayesian-methods/bbb_toy.py
   mirrored at its own sizes, its first steps against the CPU and its
   main to its asserts; a hybridized block drawing normal, gamma and
   negative binomial numbers, captured: two replays draw differently and
   each holds its mean and deviation within 5 standard errors over 10^6
   draws;
   _contrib_DeformableConvolution at R-FCN's res5 shape (Dai et al.,
   arXiv:1703.06211; data 1x512x38x63, dilate 2) held once against the
   CPU, forward and forward + backward timed beside Convolution;
36. sparse arrays (ROADMAP A9's sparse half), no kernel of their own:
   example/sparse/linear_classification.py's model (CSR data, a
   row_sparse weight, SoftmaxOutput(dot)) at Avazu-app's width (MXNet's
   run of that example on LIBSVM avazu-app: 1,000,001 features, batch
   8,192) through Module.fit with Adam on gpu(0), fed CSR batches by
   LibSVMIter from synthetic rows (22 fields, skewed columns, labels from
   a planted weight; 24 batches, 2 epochs, 4 held out): its first 3
   steps against the CPU, held-out accuracy above AV_ACC, the fit's rise
   in allocated memory under 1 GiB (a dense batch would be 32.8 GB),
   each step's stored gradient rows, ms a step by part beside the step's
   bound; the example's own main on gpu(0), its first steps against the
   CPU and its asserts; gluon.contrib.nn.SparseEmbedding at LM1B's
   vocabulary and width (793,471 x 512) through one lazy SGD Trainer
   step: the compact gradient's rows, the backward's memory under 100 MB,
   the touched rows against the CPU and every other row unchanged;
37. durability and precision (ROADMAP A10), no kernel of its own:
   MXTPU_AMP=bf16 in the captured Module step on ResNet-50 (224, batch
   128, train_imagenet.py's fit call from phase 26's weights): its first
   3 steps' losses against the float32 captured step within AMP_LOSS_ULPS
   units of bfloat16's roundoff, the first step's size within
   AMP_MOVE_TOL of float32's and its direction within AMP_DIR_SPREAD of
   the float32 step's own spread from weights bfloat16's rounding apart
   (this run's and the drill's), float32 masters, momenta and BatchNorm
   statistics in the store, one capture, ms a step in turns with float32
   (TF32 off and on) beside the bf16 bound, one replay profiled, the
   peak memory; the overflow drill (MXTPU_AMP_LOSS_SCALE=1024,
   kind=nan_grad at module.step on the third step: every written tensor
   bitwise unchanged, amp_overflow_skips() 1, the fourth step finite);
   the bucketed LM at PTB's widths under AMP over phase 28's sentences
   and epochs (lstm_scan's nodes in each bucket's graph a bfloat16 x_proj
   instantiation by cuFuncGetName, launches counted from 0, the kernel at
   bucket 32 in those dtypes against its plain loop, timed in interleaved
   pairs with cuDNN's bf16 LSTM (itself held to the plain loop), the log
   perplexity within AMP_PPL_SPREAD times the fit's own spread at
   bfloat16's scale, an AMP fit at half the learning rate outside that
   band, ms a step by bucket); CheckpointManager on Gluon's resnet18_v1 (saved at step 5
   with its Trainer, restored into a fresh net: 3 more steps bitwise
   equal to the run never stopped, the file's weight_digest equal to the
   card's parameters', the host ms save blocks, the write's seconds, the
   step's MB); ResNet-50's weights in MXNet's binary .params through
   Module.load, the forward bitwise equal to the .npz checkpoint's;
   train_imagenet.py --dtype float16 at ResNet-50's width, 5 captured
   steps, each float16 weight its float32 master rounded;
38. timings: each kernel, its plain version and the PyTorch library call
   computing the same function (cuDNN RNNs; scaled_dot_product_attention;
   torch.softmax), beside the least time the card could take (CUDA
   events; where a launch is shorter than its host cost, events around
   calls enqueued behind a sleep kernel: the flash kernels at the
   training slice's shape, the head kernels and the LSTM/GRU kernels,
   where the f32 backward and the head's forward are timed in
   interleaved pairs against SDPA's backward and torch.softmax, and the
   LSTM/GRU kernels against cuDNN at N=32 and N=1 by wall time per call,
   cuDNN's launches waiting for the card); the served LM forward's card
   time; the
   serving slice's requests/s and tokens scored/s at bucket 32; the
   LSTM/GRU forward + backward under autograd beside cuDNN's; the
   training slices' ms per step and where a step's device time goes;
   NVRTC's compile time and the host cost of one rtc launch; the
   custom-op model's requests/s at bucket 128; Module.fit's eager and
   captured steps beside cs_step's;
39. one JSON line naming every kernel with its launches (the head
   kernels': in the MLP's captured Module.fit; lstm_scan's and gru_scan's:
   in the bucketed LM's captured fits, and in the Gluon LM's runs as
   launches_gluon_lm, lstm_scan's in the checkpointed fit as
   launches_rnn_checkpoint, in phase 37's AMP LM as launches_amp with its
   bfloat16 time at bucket 32 (amp_*), in phases 30, 32 and 34 as
   launches_ctc_examples, launches_gluon_cells and launches_gluon_examples,
   gru_scan's in DeepSpeech 2's captured fit as launches_deepspeech2 with
   its time at that shape (ds2_*) and ctc_loss's; multibox_nms's: in the
   SSD slice's decodes,
   in the R-CNN toy as launches_rcnn_toy and in phase 21's box_nms
   checks as launches_box_nms, with its time at Proposal's shape and
   box_nms's at SSD-300's) and error;
40. the last line: {"ok": true, "device": {...}}.

It needs one card and the repository around it; without either it
exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import random
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

VOCAB, EMBED, HIDDEN, LAYERS, SEQ = 10000, 200, 200, 2, 32
BUCKETS = (1, 2, 4, 8, 16, 32)
REQUEST_ROWS = (1, 3, 8, 17, 32, 5, 2, 32)
GRU_REQUEST_ROWS = (4, 32, 9)

# Kernel vs plain version on the same card and inputs. float32: both
# carry h and c in f32 and differ only in the order of the 200-term dot
# products, so after 32 steps the drift stays far below 1e-4. bfloat16:
# the carry is f32 in both, but each step's h is rounded to bf16 for ys;
# a last-bit difference in f32 can flip that rounding by one bf16 ulp
# (2**-8 at |h| < 1), and cT (|c| can pass 1) by one ulp of its own
# magnitude. Allow four ulps.
F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=4 * 2.0 ** -8, rtol=4 * 2.0 ** -8)
# Gradients of lstm_scan/gru_scan, card vs CPU: both recompute the plain
# loop (the card's backward) and differentiate it; float32 differs in
# summation order only, as F32_TOL allows for the forward. bfloat16: each
# gradient is summed in f32 and rounded to bf16 once, where a last-bit
# difference can flip that rounding by one ulp: BF16_TOL.
RNN_GRAD_F32_TOL = F32_TOL
RNN_GRAD_BF16_TOL = BF16_TOL
# SoftmaxOutput's output and gradient, card vs CPU: f32 softmax over 10
# classes, the same arithmetic in another order (a few ulps of values <= 1).
SOFTMAX_OUTPUT_TOL = dict(atol=1e-6, rtol=0)
# The served LM, card vs CPU, float32 softmax outputs (each <= 1): the
# matmuls (TF32 off) and the recurrence differ in summation order only.
SERVE_TOL = dict(atol=1e-6, rtol=1e-3)

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 outside the
# tensor cores (where these kernels compute), and the dense bf16
# tensor-core rate that bf16 attention is bounded against
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12

# The training slice: example/long-context/ring_attention_lm.py at its
# own widths, trained with its Adam recipe.
LM_VOCAB, LM_DIM, LM_HEADS, LM_SEQ, LM_PERIOD = 32, 64, 4, 256, 16
LM_BATCH, LM_STEPS, LM_LR = 8, 300, 3e-3
LM_PARAMS = {"emb": (LM_VOCAB, LM_DIM), "pos": (LM_SEQ, LM_DIM),
             "wq": (LM_DIM, LM_DIM), "wk": (LM_DIM, LM_DIM),
             "wv": (LM_DIM, LM_DIM), "wo": (LM_DIM, LM_DIM),
             "head": (LM_DIM, LM_VOCAB)}
# Flash kernels vs their plain versions on the card. float32: both sum
# the same f32 products in another order (the plain one through cuBLAS
# with TF32 off); measured differences stay below 2e-6 at |x| < 10. bf16:
# both compute in f32 from the same bf16 inputs and round each output
# once, so a last-bit f32 difference can flip that rounding by one bf16
# ulp, at most 2^-7 of the value; lse is f32 either way.
FLASH_F32_TOL = dict(atol=1e-5, rtol=1e-5)
FLASH_BF16_TOL = dict(atol=2.0 ** -8, rtol=2.0 ** -7)
# The bf16 kernels (csrc/flash_attention_sm90.cu) against the same f32
# plain versions. The kernels round P (dS) to bf16 before P.V, P^T.dO
# (dS.K, dS^T.Q), as the TPU's one-pass bf16 dot does; the plain versions
# keep them f32. Rounding to nearest moves each p or ds by at most u =
# 2^-8 of itself (bf16 keeps 8 significant bits), so, from the plain
# version's own P and dS (sm90_allowance):
#   |O_id - O'_id|    <= u (P |V|)_id / l_i             (p >= 0, elementwise)
#   ||dQ_i - dQ'_i||  <= u || (|dS| |K|)_i ||            (a row's 2-norm)
#   |dV_jd - dV'_jd|  <= u (P^T |dO|)_jd                 (p >= 0, elementwise)
#   ||dK_j - dK'_j||  <= u || (|dS|^T |Q|)_j ||          (a key row's 2-norm)
# dS.K and dS^T.Q cancel (ds is signed, and each row of dS sums to about
# 0), so dQ and dK are held per row in norm: next to a near-zero element
# the rounding of the terms that cancelled into it still shows. On top of
# that, both sides round their f32 result to bf16 once, and a last-bit
# difference can flip that rounding: 2^-7 of the value (SM90_OUT_RTOL, as
# FLASH_BF16_TOL); the f32 sums run in another order, at most 1e-5 an
# element at these magnitudes (SM90_SUM_ATOL, FLASH_F32_TOL's atol). lse
# is f32 on both sides: l sums up to Tk positive terms in another order,
# Tk 2^-24 of itself at most (4.9e-4 at 8,192 keys), and exp2 with log2 e
# folded into the scale moves an exponent by 2^-24 of |s scale log2 e|
# (below 2e-6 here).
SM90_U = 2.0 ** -8
SM90_OUT_RTOL = 2.0 ** -7
SM90_SUM_ATOL = 1e-5
SM90_LSE_TOL = dict(atol=5e-4, rtol=0.0)
# The LM's first steps, card (kernels) vs CPU (plain versions): f32 sums
# in another order inside attention and the products around it. Adam
# moves each weight by about lr a step whatever the gradient's size, so
# where a gradient is near 0 a last-bit difference moves the weight by
# far more than its own size: the CPU's flash and dense attention routes,
# which differ only in such sums, end 3 steps 4.1e-6 apart.
LM_TOL = dict(atol=3e-5, rtol=1e-5)
# LSTM/GRU kernel shapes beyond the served ones, (T, N, H, dtype name):
# ragged unit slices (H=37, 37 units over 8 CTAs), the streamed mode (H=512
# f32: the weight slice does not fit shared memory; clusters of 16, 4 rows,
# N=33 leaves the last cluster one row), ragged rows at the resident mode
# (N=50: 13 clusters of 4 rows, the last with 2), the plan's 3 rows (N=33)
# and one step (T=1); DeepSpeech 2's GRU launch (T=100, N=12, H=1760 f32,
# streamed)
RNN_EXTRA_SHAPES = ((SEQ, 32, 37, "float32"), (SEQ, 33, 37, "bfloat16"),
                    (SEQ, 33, 512, "float32"), (SEQ, 33, HIDDEN, "float32"),
                    (SEQ, 50, HIDDEN, "float32"), (1, 32, HIDDEN, "float32"),
                    (1, 1, HIDDEN, "bfloat16"), (100, 12, 1760, "float32"))
# interleaved (kernel, library call) timings where the two are close: the
# head kernels against torch.softmax, the f32 flash backward (dQ + dK/dV)
# at the training slice's shape against SDPA's backward
PAIRS = 7


def fail(msg):
    print("chip_smoke: FAILED: %s" % msg, file=sys.stderr)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail("nvidia-smi: %s" % out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=50, warmup=5):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def held_ms(fn, iters=50, warmup=5, required=True):
    """Device ms per call of ``fn`` where one call takes the card less time
    than the host takes to enqueue it: CUDA events around ``iters`` calls
    enqueued while a sleep kernel holds the stream, so the card runs them
    back to back whatever the host's launch cost. The start event must
    still be pending once the last call is enqueued; the sleep grows until
    it is. A call that waits for the card cannot be held: that fails, or
    gives None where not ``required``."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 22                        # about 2 ms at 1.98 GHz
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        held = not start.query()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / iters
        cycles *= 4
    if not required:
        return None
    fail("a sleep of %d cycles did not outlast enqueueing %d calls"
         % (cycles // 4, iters))


# host calls that put work on the card, as the profiler names them
LAUNCH_CALLS = frozenset((
    "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
    "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
    "cudaMemsetAsync"))


def device_time(fn, calls, per=1):
    """Device busy ms (None where the profiler recorded no kernel time),
    the kernels the card ran, the host's launch calls (a graph launch is
    one) and the top kernels (ms) per unit of work, from torch.profiler
    over ``calls`` calls of ``fn`` that do ``per`` units each. For the
    breakdowns only: no check depends on it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return None, "not measured (the profiler recorded no kernel time)"
    events.sort(key=lambda e: -e.self_device_time_total)
    n = calls * per
    busy = sum(e.self_device_time_total for e in events) / n / 1e3
    launches = sum(e.count for e in events) / n
    host = sum(e.count for e in averages if e.key in LAUNCH_CALLS) / n
    top = ", ".join("%s %.4f" % (e.key[:48], e.self_device_time_total / n
                                 / 1e3) for e in events[:8])
    return busy, "%.0f kernel launches (%.1f host launch calls); %s" % (
        launches, host, top)


def prof_ms(fn, calls):
    """The profiler's kernel ms per call of ``fn``, as text."""
    busy, _top = device_time(fn, calls)
    return "not measured" if busy is None else "%.4f ms" % busy


def busy_of(busy, wall_ms):
    """A breakdown's card busy ms beside ``wall_ms``, or why it is
    missing."""
    if busy is None:
        return "card busy not measured"
    return "card busy %.3f ms of %.3f ms (idle %.0f%%)" % (
        busy, wall_ms, 100 * (1 - busy / wall_ms))


def ptxas_report(log):
    """{entry: (registers, spill store bytes, spill load bytes)} from
    nvcc's -Xptxas -v output."""
    report, entry, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry, spills = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            report[entry] = (int(m.group(1)),) + spills
    return report


def max_err(got, want):
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want))


def check_close(name, got, want, tol):
    import torch
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            fail("%s output %d: %s %s vs plain %s %s"
                 % (name, i, tuple(g.shape), g.dtype, tuple(w.shape),
                    w.dtype))
        if not torch.allclose(g.float(), w.float(), **tol):
            fail("%s output %d differs from the plain version by %g (%s)"
                 % (name, i, float((g.float() - w.float()).abs().max()),
                    tol))


def rnn_kernel_label(entry):
    """'lstm f32/f32 R=2'-style name of an rnn_cluster_kernel entry."""
    m = re.search(r"rnn_cluster_kernelILi(\d)E(\w+?)Li(\d)E", entry)
    if not m:
        return None
    kind, types, rows = m.groups()
    types = {"ff": "f32/f32", "f13__nv_bfloat16": "f32/bf16",
             "13__nv_bfloat16f": "bf16/f32",
             "13__nv_bfloat16S1_": "bf16/bf16"}.get(types, types)
    return "%s %s R=%s" % ("gru" if kind == "1" else "lstm", types, rows)


# ---------------------------------------------------------------------------
# kernel inputs at the slice's shapes
# ---------------------------------------------------------------------------

def lstm_args(rng, N, dtype, dev, T=SEQ, H=HIDDEN):
    import torch
    arrays = [rng.standard_normal((T, N, 4 * H)),
              rng.standard_normal((N, H)) * 0.5,
              rng.standard_normal((N, H)) * 0.5,
              rng.standard_normal((H, 4 * H)) * 0.07]
    return [torch.from_numpy(a.astype(np.float32)).to(dev).to(dtype)
            for a in arrays]


def gru_args(rng, N, dtype, dev, T=SEQ, H=HIDDEN):
    import torch
    arrays = [rng.standard_normal((T, N, 3 * H)),
              rng.standard_normal((N, H)) * 0.5,
              rng.standard_normal((H, 2 * H)) * 0.07,
              rng.standard_normal((H, H)) * 0.07,
              rng.standard_normal((H,)) * 0.1]
    return [torch.from_numpy(a.astype(np.float32)).to(dev).to(dtype)
            for a in arrays]


def cudnn_lstm(xp, h0, c0, wh_t):
    """torch.nn.LSTM (cuDNN) set up to compute lstm_scan's function:
    identity input weights feed x_proj straight into the gates."""
    import torch
    G, H = xp.shape[-1], h0.shape[-1]
    m = torch.nn.LSTM(G, H).to(xp.device, xp.dtype)
    with torch.no_grad():
        m.weight_ih_l0.copy_(torch.eye(G, device=xp.device))
        m.weight_hh_l0.copy_(wh_t.t())
        m.bias_ih_l0.zero_()
        m.bias_hh_l0.zero_()
    h0, c0 = h0[None], c0[None]

    def call():
        with torch.no_grad():
            ys, (hT, cT) = m(xp, (h0, c0))
        return ys, hT[0], cT[0]
    return call


def cudnn_gru(xp, h0, whrz_t, whn_t, bhn):
    """torch.nn.GRU (cuDNN) set up to compute gru_scan's function; the
    r/z recurrent bias is already folded into x_proj."""
    import torch
    G, H = xp.shape[-1], h0.shape[-1]
    m = torch.nn.GRU(G, H).to(xp.device)
    with torch.no_grad():
        m.weight_ih_l0.copy_(torch.eye(G, device=xp.device))
        m.weight_hh_l0.copy_(torch.cat([whrz_t.t(), whn_t.t()], 0))
        m.bias_ih_l0.zero_()
        m.bias_hh_l0.copy_(torch.cat([bhn.new_zeros(2 * H), bhn]))
    h0 = h0[None]

    def call():
        with torch.no_grad():
            ys, hT = m(xp, h0)
        return ys, hT[0]
    return call


def cudnn_train(kind, a, cots):
    """torch.nn.LSTM / GRU (cuDNN) set up as cudnn_lstm / cudnn_gru, as one
    call of forward and backward: the gradients of x_proj, the state and
    the recurrent weights under the cotangents ``cots`` of (ys, hT). The
    identity input weights take no gradient of their own, though cuDNN
    computes one for its weight blob."""
    import torch
    xp, h0 = a[0], a[1]
    G, H = xp.shape[-1], h0.shape[-1]
    m = (torch.nn.LSTM if kind == "lstm" else torch.nn.GRU)(G, H).to(
        xp.device)
    with torch.no_grad():
        m.weight_ih_l0.copy_(torch.eye(G, device=xp.device))
        m.bias_ih_l0.zero_()
        if kind == "lstm":
            m.weight_hh_l0.copy_(a[3].t())
            m.bias_hh_l0.zero_()
        else:
            m.weight_hh_l0.copy_(torch.cat([a[2].t(), a[3].t()], 0))
            m.bias_hh_l0.copy_(torch.cat([a[4].new_zeros(2 * H), a[4]]))
    for p in (m.weight_ih_l0, m.bias_ih_l0):
        p.requires_grad_(False)
    xp = xp.detach().requires_grad_()
    state = [t.detach()[None].requires_grad_() for t in a[1:3 if kind ==
                                                           "lstm" else 2]]
    wanted = [xp, *state, m.weight_hh_l0, m.bias_hh_l0]

    def call():
        if kind == "lstm":
            ys, (hT, _cT) = m(xp, tuple(state))
        else:
            ys, hT = m(xp, state[0])
        return torch.autograd.grad((ys, hT), wanted, (cots[0], cots[1][None]))
    return call


def rnn_kernel_phase(rnn_scan, rng, dev):
    """lstm_scan and gru_scan against their plain loops on the card: the
    serving slice's shapes (T=32, H=200, N in {1, 32}, f32 and bf16) and
    RNN_EXTRA_SHAPES. A second call of each kernel must give the same
    bits. Prints each launch's plan (cluster size, rows a cluster, mode)
    and how many of its clusters the card holds at once. Returns each
    kernel's largest error at the served shapes in f32."""
    import torch
    errs = {"lstm_scan": 0.0, "gru_scan": 0.0}
    cases = [(SEQ, N, HIDDEN, dtype) for N in (1, 32)
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(T, N, H, getattr(torch, d)) for T, N, H, d in
              RNN_EXTRA_SHAPES + GL_LM_KERNEL_SHAPES]
    for T, N, H, dtype in cases:
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        report = []
        for name, make in (("lstm_scan", lstm_args), ("gru_scan", gru_args)):
            a = make(rng, N, dtype, dev, T=T, H=H)
            fn = getattr(rnn_scan, name)
            got = fn(*a)
            again = fn(*a)
            torch.cuda.synchronize()
            label = "%s T=%d N=%d H=%d %s" % (name, T, N, H, dtype)
            if any(not torch.equal(x, y) for x, y in zip(got, again)):
                fail("%s: a second call gave other bits" % label)
            want = getattr(rnn_scan, name + "_reference")(*a)
            check_close(label, got, want, tol)
            err = max_err(got, want)
            if dtype == torch.float32 and T == SEQ and H == HIDDEN and \
                    N in (1, 32):
                errs[name] = max(errs[name], err)
            plan = rnn_scan.scan_plan(name.split("_")[0], T, N, H, dtype,
                                      dtype)
            report.append(
                "%s max err %.3g, plan: clusters of %d CTAs x %d rows, %s, "
                "%d threads, %d B shared a CTA, %d clusters (%d at once)"
                % (name, err, plan.cluster, plan.rows, plan.mode,
                   plan.threads, plan.smem, plan.clusters,
                   rnn_scan.max_active_clusters(name, plan, N, dtype,
                                                dtype)))
        print("check T=%d N=%d H=%d %s (tolerance %s), two calls bitwise "
              "equal: %s" % (T, N, H, dtype, tol, "; ".join(report)))
    # what the plan assumes of the card: how many clusters it holds at one
    # CTA an SM (shared memory above half an SM's forces one)
    held = {}
    for C in sorted(rnn_scan.CLUSTERS_AT_ONCE):
        plan = rnn_scan.scan_plan("lstm", SEQ, 1, HIDDEN, torch.float32,
                                  torch.float32)._replace(cluster=C,
                                                          smem=150 * 1024)
        held[C] = rnn_scan.max_active_clusters("lstm_scan", plan, 1,
                                               torch.float32, torch.float32)
    print("rnn plan: the card holds %s clusters of %s CTAs at one CTA an SM "
          "(cudaOccupancyMaxActiveClusters); the plan assumes %s"
          % ("/".join(str(held[C]) for C in sorted(held)),
             "/".join(str(C) for C in sorted(held)),
             "/".join(str(rnn_scan.CLUSTERS_AT_ONCE[C]) for C in sorted(held))))
    return errs


def rnn_grad_phase(rnn_scan, rng, dev):
    """lstm_scan and gru_scan gradients on the card (f32 and bf16, N = 1
    and 32, T=32, H=200) against the CPU's plain autograd, every input's;
    the cotangents reach ys and hT, so LSTM's cT goes unused. Each forward
    launches its kernel once, under the autograd Function, and the
    backward (a recompute through the plain loop) launches none."""
    import torch
    for N in (1, 32):
        for dtype, tol in ((torch.float32, RNN_GRAD_F32_TOL),
                           (torch.bfloat16, RNN_GRAD_BF16_TOL)):
            for name, make in (("lstm_scan", lstm_args),
                               ("gru_scan", gru_args)):
                fn = getattr(rnn_scan, name)
                a = make(rng, N, dtype, dev)
                card = [t.requires_grad_() for t in a]
                cpu = [t.detach().cpu().requires_grad_() for t in a]
                rnn_scan.reset_launches()
                outs = fn(*card)
                fwd = dict(rnn_scan.LAUNCHES)
                cots = [torch.from_numpy(rng.standard_normal(tuple(
                    o.shape)).astype(np.float32)).to(dev).to(o.dtype)
                    for o in outs[:2]]
                got = torch.autograd.grad(outs[:2], card, cots)
                torch.cuda.synchronize()
                label = "%s gradients N=%d %s" % (name, N, dtype)
                if fwd[name] != 1 or sum(fwd.values()) != 1 or \
                        rnn_scan.LAUNCHES != fwd or outs[0].grad_fn is None:
                    fail("%s: forward launched %s, forward and backward %s "
                         "(want one launch of %s, none in the backward, "
                         "outputs in the graph)"
                         % (label, fwd, dict(rnn_scan.LAUNCHES), name))
                want = torch.autograd.grad(fn(*cpu)[:2], cpu,
                                           [c.cpu() for c in cots])
                got = [g.cpu() for g in got]
                check_close(label + ", card vs CPU", got, list(want), tol)
                print("check %s: every input's gradient within %s of the "
                      "CPU's plain autograd (max err %.3g); launches forward "
                      "%d, backward 0" % (label, tol, max_err(got, want),
                                          fwd[name]))


def rnn_train_times(rnn_scan, rng, dev, card):
    """One lstm_scan / gru_scan forward + backward at the served LM's
    shape (T=32, N=32, H=200, f32) beside cuDNN's: wall ms per call
    (events over back-to-back calls; the recompute is host-bound) and the
    backward as forward + backward less forward."""
    import torch
    N = BUCKETS[-1]
    for name, kind, make, library in (
            ("lstm_scan", "lstm", lstm_args, cudnn_lstm),
            ("gru_scan", "gru", gru_args, cudnn_gru)):
        fn = getattr(rnn_scan, name)
        a = [t.requires_grad_() for t in make(rng, N, torch.float32, dev)]
        outs = fn(*a)
        cots = [torch.randn_like(o) for o in outs[:2]]

        def ours():
            return torch.autograd.grad(fn(*a)[:2], a, cots)
        theirs = cudnn_train(kind, [t.detach() for t in a], cots)
        fwd_ms = cuda_ms(lambda: fn(*[t.detach() for t in a]), iters=20)
        both_ms = cuda_ms(ours, iters=10, warmup=2)
        lib_fwd = cuda_ms(library(*[t.detach() for t in a]), iters=20)
        lib_both = cuda_ms(theirs, iters=10, warmup=2)
        print("time %s forward+backward T=%d N=%d H=%d f32 (events, wall per "
              "call): kernel forward + recompute backward %.4f ms, backward "
              "%.4f ms; cuDNN forward+backward %.4f ms, backward %.4f ms | %s"
              % (name, SEQ, N, HIDDEN, both_ms, both_ms - fwd_ms, lib_both,
                 lib_both - lib_fwd, card))


def softmax_output_phase(mt):
    """nd.SoftmaxOutput forward and backward under autograd on gpu(0)
    against the CPU, on the options of mxtpu's backward."""
    import torch
    rng = np.random.RandomState(5)
    cases = [dict(), dict(grad_scale=2.0, normalization="batch"),
             dict(use_ignore=True, ignore_label=3.0, normalization="valid",
                  smooth_alpha=0.1),
             dict(multi_output=True, normalization="valid"),
             dict(out_grad=True)]
    worst = 0.0
    for kw in cases:
        shape = (CS_BATCH, CS_CLASSES, 6) if kw.get("multi_output") \
            else (CS_BATCH, CS_CLASSES)
        x = (rng.standard_normal(shape) * 3).astype(np.float32)
        lab = rng.randint(0, CS_CLASSES, (shape[0],) + shape[2:]).astype(
            np.float32)
        head = rng.standard_normal(shape).astype(np.float32)
        res = []
        for ctx in (mt.gpu(0), mt.cpu()):
            a = mt.nd.array(x, ctx=ctx)
            a.attach_grad()
            with mt.autograd.record():
                y = mt.nd.SoftmaxOutput(a, mt.nd.array(lab, ctx=ctx), **kw)
            y.backward(mt.nd.array(head, ctx=ctx))
            res.append([y.data.detach().cpu(), a.grad.data.cpu()])
        check_close("SoftmaxOutput %s, card vs CPU" % kw, res[0], res[1],
                    SOFTMAX_OUTPUT_TOL)
        if not float(res[0][1].abs().max()) > 0:
            fail("SoftmaxOutput %s gave a zero gradient on the card" % kw)
        worst = max(worst, max_err(res[0], res[1]))
    print("check nd.SoftmaxOutput backward on gpu(0), %d option sets "
          "(grad_scale, normalization batch/valid, use_ignore, smooth_alpha, "
          "multi_output, out_grad; a head gradient given each time): max "
          "|card - cpu| %.3g (tolerance %s)"
          % (len(cases), worst, SOFTMAX_OUTPUT_TOL))


def attention_route_phase(fa, rng, dev):
    """local_attention(impl="auto") on the card at T=128 runs the flash
    kernels, as mxtpu runs its Pallas kernels on the TPU, also where the
    wrapper fits the problem to them: head dim 80 zero-padded to 128,
    float16 on the f32 kernels, a bf16 tensor off a 16-byte boundary
    copied. Launches, and forward and backward against the dense path on
    the CPU."""
    import torch
    from mxtpu_torch.parallel import local_attention
    f32 = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    sm90 = tuple(n + "_sm90" for n in f32)
    # 16 bits: each output rounded once, and in bf16 P and dS before their
    # products, 2^-8 of values below 4; float16 rounds each output once
    tols = {torch.float32: FLASH_F32_TOL,
            torch.bfloat16: dict(atol=2.0 ** -6, rtol=2.0 ** -6),
            torch.float16: dict(atol=2.0 ** -9, rtol=2.0 ** -9)}
    for D, dtype, misaligned, kernels in ((80, torch.float32, False, f32),
                                          (64, torch.float16, False, f32),
                                          (64, torch.bfloat16, False, sm90),
                                          (80, torch.bfloat16, True, sm90)):
        arrays = [rng.standard_normal((1, 2, 128, D)).astype(np.float32)
                  for _ in range(4)]
        card = []
        for x in arrays[:3]:
            t = torch.from_numpy(x).to(dev).to(dtype)
            if misaligned:
                t = torch.zeros(t.numel() + 1, dtype=dtype, device=dev)[
                    1:].view(t.shape).copy_(t)
                if not t.data_ptr() % 16:
                    fail("local_attention: the misaligned case is aligned")
            card.append(t.requires_grad_())
        fa.reset_launches()
        o = local_attention(*card, causal=True, impl="auto")
        do = torch.from_numpy(arrays[3]).to(dev).to(dtype)
        grads = torch.autograd.grad(o, card, do)
        torch.cuda.synchronize()
        want_launches = {n: int(n in kernels) for n in fa.LAUNCHES}
        if dict(fa.LAUNCHES) != want_launches:
            fail("local_attention auto D=%d %s%s launched %s, want %s"
                 % (D, dtype, " misaligned" if misaligned else "",
                    dict(fa.LAUNCHES), want_launches))
        # the CPU's dense path in f32 on the same (rounded) inputs
        cpu = [t.detach().float().cpu().requires_grad_() for t in card]
        o_p = local_attention(*cpu, causal=True, impl="xla")
        g_p = torch.autograd.grad(o_p, cpu, do.float().cpu())
        got = [g.detach().float().cpu() for g in (o, *grads)]
        want = [w.detach() for w in (o_p, *g_p)]
        for g, w in zip(got, want):
            if g.shape != w.shape:
                fail("local_attention auto D=%d %s: shape %s, want %s"
                     % (D, dtype, tuple(g.shape), tuple(w.shape)))
        err = max_err(got, want)
        check_close("local_attention auto D=%d %s" % (D, dtype), got, want,
                    tols[dtype])
        print("route local_attention(impl=\"auto\") (1, 2, 128, %d) %s%s: "
              "flash, launches %s, forward and backward max |card - cpu "
              "dense| %.3g (tolerance %s)"
              % (D, dtype, " off a 16-byte boundary" if misaligned else "",
                 {n: fa.LAUNCHES[n] for n in kernels}, err, tols[dtype]))


def bound(kind, N, itemsize=4, T=SEQ, H=HIDDEN):
    """Least time (ms) for one call at (T, N, H): each input read once and
    each output written once at the HBM rate, against the h.Wh products
    and the gate math at the float32 rate."""
    if kind == "lstm":
        elems = T * N * 4 * H + H * 4 * H + 2 * N * H + T * N * H + 2 * N * H
        flops = T * (2 * N * H * 4 * H + 10 * N * H)
    else:
        elems = (T * N * 3 * H + H * 2 * H + H * H + H + N * H
                 + T * N * H + N * H)
        flops = T * (2 * N * H * 3 * H + 12 * N * H)
    t_bytes = elems * itemsize / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------

def lm_symbol(mt, mode):
    data = mt.sym.var("data")
    embed = mt.sym.Embedding(data, input_dim=VOCAB, output_dim=EMBED,
                             name="embed")
    cell = mt.rnn.FusedRNNCell(HIDDEN, num_layers=LAYERS, mode=mode,
                               prefix="lstm_")
    outputs, _ = cell.unroll(SEQ, inputs=embed, layout="NTC",
                             merge_outputs=True)
    pred = mt.sym.FullyConnected(outputs, num_hidden=VOCAB, flatten=False,
                                 name="pred")
    return mt.sym.softmax(pred, axis=-1, name="softmax")


def write_checkpoint(mt, mode, seed, prefix):
    sym = lm_symbol(mt, mode)
    args, _, _ = sym.infer_shape(data=(1, SEQ))
    rng = np.random.RandomState(seed)
    params = {n: (rng.uniform(-0.1, 0.1, s)).astype(np.float32)
              for n, s in zip(sym.list_arguments(), args) if n != "data"}
    arg_params, aux_params = mt.model.params_from_numpy(params, {},
                                                        ctx=mt.cpu())
    mt.model.save_checkpoint(prefix, 0, sym, arg_params, aux_params)


def serve(mt, rnn_scan, mode, seed, rows_list, workdir):
    """Serve the LM on cuda:0 and on the CPU from one checkpoint; returns
    (engine on the card, launches per kernel during the card's run)."""
    prefix = os.path.join(workdir, "lm-%s" % mode)
    write_checkpoint(mt, mode, seed, prefix)
    kw = dict(data_shapes={"data": (SEQ,)}, buckets=BUCKETS)
    gpu = mt.serving.InferenceEngine.from_checkpoint(prefix, 0,
                                                     ctx=mt.gpu(0), **kw)
    if gpu.stats()["compiles"] != len(BUCKETS):
        fail("warm() prepared %d programs for %d buckets"
             % (gpu.stats()["compiles"], len(BUCKETS)))
    rng = np.random.RandomState(seed + 1)
    requests = [rng.randint(0, VOCAB, (r, SEQ)).astype(np.float32)
                for r in rows_list]
    rnn_scan.reset_launches()
    answers = [gpu.predict([req]) for req in requests]
    launches = dict(rnn_scan.LAUNCHES)
    stats = gpu.stats()
    if stats["compiles"] != len(BUCKETS) or stats["hits"] != len(requests):
        fail("program cache moved while serving: %s" % stats)
    cpu = mt.serving.InferenceEngine.from_checkpoint(prefix, 0,
                                                     ctx=mt.cpu(), **kw)
    worst = 0.0
    for req, got in zip(requests, answers):
        want = cpu.predict([req])
        out, ref = got[0], want[0]
        if out.shape != (req.shape[0], SEQ, VOCAB) or \
                not np.isfinite(out).all():
            fail("%s LM answer has shape %s or non-finite values"
                 % (mode, out.shape))
        if not np.allclose(out.sum(-1), 1.0, atol=1e-4):
            fail("%s LM rows are not distributions" % mode)
        if not np.allclose(out, ref, **SERVE_TOL):
            fail("%s LM on the card differs from the CPU by %g"
                 % (mode, float(np.abs(out - ref).max())))
        worst = max(worst, float(np.abs(out - ref).max()))
    print("slice %s: %d requests (rows %s) served on %s, max |card - cpu| "
          "= %.3g, launches %s, cache %s"
          % (mode, len(requests), list(rows_list), gpu.device, worst,
             launches, {k: stats[k] for k in ("compiles", "hits")}))
    return gpu, launches


# ---------------------------------------------------------------------------
# the training slice: the causal attention LM
# ---------------------------------------------------------------------------

def lm_init_params(seed):
    """The example's init_params: every weight N(0, 0.1^2), f32."""
    rng = np.random.RandomState(seed)
    return {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
            for k, s in LM_PARAMS.items()}


def lm_batch(rng, bsz):
    """The example's batch: a random head of PERIOD tokens repeated, so
    token t equals token t - PERIOD; (bsz, SEQ + 1) int64."""
    head = rng.randint(0, LM_VOCAB, (bsz, LM_PERIOD))
    reps = (LM_SEQ + 1 + LM_PERIOD - 1) // LM_PERIOD
    return np.tile(head, (1, reps))[:, :LM_SEQ + 1].astype(np.int64)


def lm_logits(params, tokens, impl="auto"):
    """The example's model: tokens (B, T) -> logits (B, T, V); attention
    through mxtpu_torch.parallel.local_attention (causal)."""
    from mxtpu_torch.parallel import local_attention
    x = params["emb"][tokens] + params["pos"][:tokens.shape[1]]
    b, t, d = x.shape

    def heads(h):                                 # [B, T, D] -> [B, H, T, dh]
        return h.reshape(b, t, LM_HEADS, d // LM_HEADS).transpose(1, 2)

    q, k, v = (heads(x @ params[w]) for w in ("wq", "wk", "wv"))
    o = local_attention(q, k, v, causal=True, impl=impl)
    o = o.transpose(1, 2).reshape(b, t, d)
    x = x + o @ params["wo"]
    return x @ params["head"]


def lm_loss(params, tokens, impl="auto"):
    """The example's loss_fn: mean next-token nll over positions >= PERIOD."""
    import torch
    logits = lm_logits(params, tokens[:, :-1], impl)
    targets = tokens[:, 1:]
    logp = torch.log_softmax(logits, dim=-1)
    mask = (torch.arange(targets.shape[1], device=targets.device)
            >= LM_PERIOD).to(logp.dtype)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    return (nll * mask).sum() / (mask.sum() * targets.shape[0])


def lm_step(params, m, v, tokens, t, lr=LM_LR, impl="auto"):
    """One step of the example's hand-written Adam: returns the new
    (params, m, v) and the loss before the update."""
    import torch
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    loss = lm_loss(leaves, tokens, impl)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    b1, b2, eps = 0.9, 0.999, 1e-8
    new_p, new_m, new_v = {}, {}, {}
    with torch.no_grad():
        for (k, p), g in zip(leaves.items(), grads):
            new_m[k] = b1 * m[k] + (1 - b1) * g
            new_v[k] = b2 * v[k] + (1 - b2) * g * g
            mh = new_m[k] / (1 - b1 ** t)
            vh = new_v[k] / (1 - b2 ** t)
            new_p[k] = p - lr * mh / (torch.sqrt(vh) + eps)
    return new_p, new_m, new_v, loss.detach()


def lm_train(params, batches, dev, impl="auto"):
    """Adam from ``params`` (numpy) over ``batches`` (token tensors on
    ``dev``); returns the params after the last update and the losses,
    one per step, as tensors on ``dev``."""
    import torch
    p = {k: torch.from_numpy(a).to(dev) for k, a in params.items()}
    m = {k: torch.zeros_like(a) for k, a in p.items()}
    v = {k: torch.zeros_like(a) for k, a in p.items()}
    losses = []
    for i, tokens in enumerate(batches):
        p, m, v, loss = lm_step(p, m, v, tokens, i + 1, impl=impl)
        losses.append(loss)
    return p, torch.stack(losses)


# ---------------------------------------------------------------------------
# flash attention: kernels vs plain versions, bounds
# ---------------------------------------------------------------------------

def flash_inputs(rng, B, H, Tq, Tk, D, dtype, dev, q_off=0, k_off=0,
                 kv_len=None):
    """Flattened q (BH, Tq, D), k/v (BH, Tk, D), the offs vector (keys
    from ``kv_len`` on masked; default Tk), and a cotangent dO with a
    random dlse folded into delta (from the plain forward), as the
    backward kernels receive them."""
    import torch
    from mxtpu_torch.ops import flash_attention as fa

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev).to(dtype)
    q, k, v = t(B * H, Tq, D), t(B * H, Tk, D), t(B * H, Tk, D)
    offs = torch.tensor([q_off, k_off, Tk if kv_len is None else kv_len,
                         1.0 / np.sqrt(D)],
                        dtype=torch.float32, device=dev)
    do = t(B * H, Tq, D)
    o, lse = fa.flash_fwd_plain(q, k, v, offs, True)
    dlse = t(B * H, Tq).float()
    delta = ((do.float() * o.float()).sum(-1) - dlse).contiguous()
    return dict(q=q, k=k, v=v, offs=offs, do=do, lse=lse, delta=delta)


def flash_calls(fa, a):
    """{kernel: (kernel call, plain call)} on the inputs of flash_inputs."""
    q, k, v, offs = a["q"], a["k"], a["v"], a["offs"]
    bw = (q, k, v, a["do"], a["lse"], a["delta"], offs, True)
    return {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, offs, True),
                      lambda: fa.flash_fwd_plain(q, k, v, offs, True)),
        "flash_bwd_dq": (lambda: (fa.flash_bwd_dq(*bw),),
                         lambda: (fa.flash_bwd_dq_plain(*bw),)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(*bw),
                          lambda: fa.flash_bwd_dkv_plain(*bw)),
    }


def live_pairs(Tq, Tk, q_off=0, k_off=0):
    """(query, key) pairs a causal kernel must score."""
    i = np.arange(Tq)
    return int(np.clip(q_off + i - k_off + 1, 0, Tk).sum())


def flash_bound(name, BH, Tq, Tk, D, itemsize):
    """Least time (ms) for one causal call: inputs read once and outputs
    written once at the HBM rate, against the products on the live pairs
    (forward 4D flops a pair: S and PV; dQ 6D: S, dP, dS.K; dK/dV 8D: S,
    dP, P^T.dO, dS^T.Q) at the f32 rate for f32 inputs and the dense
    bf16 tensor-core rate for bf16."""
    qd, kd = BH * Tq * D * itemsize, BH * Tk * D * itemsize
    rows = BH * Tq * 4                      # one f32 per query row
    if name == "flash_fwd":
        nbytes, per_pair = qd + 2 * kd + qd + rows, 4 * D
    elif name == "flash_bwd_dq":
        nbytes, per_pair = 2 * qd + 2 * kd + 2 * rows + qd, 6 * D
    else:
        nbytes, per_pair = 2 * qd + 2 * kd + 2 * rows + 2 * kd, 8 * D
    flops = BH * live_pairs(Tq, Tk) * per_pair
    peak = PEAK_F32_FLOPS if itemsize == 4 else PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_flash(fa, rng, dev, B, H, Tq, Tk, D, dtype, tol, q_off=0,
                k_off=0, kv_len=None):
    """Each flash kernel against its plain version on one input; returns
    ({kernel: max abs error}, inputs). Each call must launch exactly the
    kernel its dtype routes to: bf16 goes to the sm90 kernels (errors
    keyed flash_fwd_sm90 / flash_bwd_dq_sm90 / flash_bwd_dkv_sm90), held
    to the derived SM90_* allowance and also printed against their
    rounding model (flash_*_bf16p_plain); f32 is held to ``tol``. A
    second call must give the same bits: no kernel sums in an order that
    changes from run to run."""
    import torch
    kv_len = Tk if kv_len is None else kv_len
    a = flash_inputs(rng, B, H, Tq, Tk, D, dtype, dev, q_off, k_off, kv_len)
    label = "B=%d H=%d Tq=%d Tk=%d D=%d %s q_off=%d k_off=%d kv_len=%d" % (
        B, H, Tq, Tk, D, dtype, q_off, k_off, kv_len)
    bf16 = dtype == torch.bfloat16
    allowance = sm90_allowance(fa, a) if bf16 else None
    bw = (a["q"], a["k"], a["v"], a["do"], a["lse"], a["delta"], a["offs"],
          True)
    model = {"flash_fwd_sm90": lambda: fa.flash_fwd_bf16p_plain(
                 a["q"], a["k"], a["v"], a["offs"], True),
             "flash_bwd_dq_sm90": lambda: (fa.flash_bwd_dq_bf16p_plain(*bw),),
             "flash_bwd_dkv_sm90": lambda: fa.flash_bwd_dkv_bf16p_plain(*bw)}
    errs, notes = {}, []
    for name, (kernel, plain) in flash_calls(fa, a).items():
        route = name + "_sm90" if bf16 else name
        fa.reset_launches()
        got = kernel()
        torch.cuda.synchronize()
        launched = {k: n for k, n in fa.LAUNCHES.items() if n}
        if launched != {route: 1}:
            fail("%s %s launched %s, want one launch of %s"
                 % (name, label, launched, route))
        again = kernel()
        torch.cuda.synchronize()
        if not all(torch.equal(g, h) for g, h in zip(got, again)):
            fail("%s %s: two calls on the same inputs differ" % (route,
                                                                 label))
        want = plain()
        if not all(bool(torch.isfinite(g.float()).all()) for g in got):
            fail("%s %s: non-finite output" % (route, label))
        if route in model:
            excess = sm90_excess(route, got, want, allowance)
            if excess > 1.0:
                fail("%s %s differs from the plain version by %.3g of its "
                     "derived allowance (max abs %g)"
                     % (route, label, excess, max_err(got, want)))
            lse = ", lse %.3g" % max_err(got[1:], want[1:]) \
                if route == "flash_fwd_sm90" else ""
            notes.append("%s %.2f of allowance, %.3g from its rounding "
                         "model%s" % (route, excess,
                                      max_err(got, model[route]()), lse))
        else:
            check_close("%s %s" % (name, label), got, want, tol)
        errs[route] = max_err(got, want)
    print("check flash %s: max err %s (tolerance %s%s), a second call "
          "bitwise equal%s"
          % (label, {k: "%.3g" % e for k, e in errs.items()}, tol,
             "; sm90 kernels: SM90_* allowance" if bf16 else "",
             "; " + "; ".join(notes) if notes else ""))
    return errs, a


def sm90_allowance(fa, a, causal=True):
    """The derived allowance of the bf16 kernels on the inputs of
    flash_inputs (see SM90_U): (O elementwise (BH, Tq, D), dQ by row
    (BH, Tq), dK by key row (BH, Tk), dV elementwise (BH, Tk, D)), from
    the plain versions' own P and dS."""
    import torch
    q, k, v, offs = a["q"], a["k"], a["v"], a["offs"]
    mask = fa._mask(offs, q.shape[1], k.shape[1], causal, q.device)
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * offs[3]
    s = torch.where(mask, s, fa._NEG)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    del s
    l = p.sum(-1, keepdim=True)
    o_slack = SM90_U * torch.matmul(p, v.float().abs()) / torch.where(
        l == 0.0, 1.0, l)
    del p
    p, ds = fa._probs_and_ds(q, k, v, a["do"], a["lse"], a["delta"], offs,
                             causal)
    dv_slack = SM90_U * torch.matmul(p.transpose(1, 2), a["do"].float().abs())
    del p
    ds = ds.abs()
    dq_slack = SM90_U * torch.matmul(ds, k.float().abs()).norm(dim=-1)
    dk_slack = SM90_U * torch.matmul(ds.transpose(1, 2),
                                     q.float().abs()).norm(dim=-1)
    return o_slack, dq_slack, dk_slack, dv_slack


def sm90_excess(route, got, want, allowance):
    """The largest share of its allowance that a bf16 kernel's output
    uses against the plain version's (above 1 fails): ``got``/``want``
    are (o, lse) for flash_fwd_sm90, (dq,) for flash_bwd_dq_sm90, (dk, dv)
    for flash_bwd_dkv_sm90."""
    import torch
    o_slack, dq_slack, dk_slack, dv_slack = allowance

    def by_row(x, x_p, slack):
        x, x_p = x.float(), x_p.float()
        allow = (slack + SM90_OUT_RTOL * x_p.norm(dim=-1)
                 + SM90_SUM_ATOL * x_p.shape[-1] ** 0.5)
        return float(((x - x_p).norm(dim=-1) / allow).max())

    def by_element(x, x_p, slack):
        x, x_p = x.float(), x_p.float()
        allow = slack + SM90_OUT_RTOL * x_p.abs() + SM90_SUM_ATOL
        return float(((x - x_p).abs() / allow).max())

    if route == "flash_fwd_sm90":
        (o, lse), (o_p, lse_p) = got, want
        if not torch.allclose(lse, lse_p, **SM90_LSE_TOL):
            fail("flash_fwd_sm90 lse differs from the plain version by %g "
                 "(%s)" % (float((lse - lse_p).abs().max()), SM90_LSE_TOL))
        return by_element(o, o_p, o_slack)
    if route == "flash_bwd_dq_sm90":
        return by_row(got[0], want[0], dq_slack)
    (dk, dv), (dk_p, dv_p) = got, want
    return max(by_row(dk, dk_p, dk_slack), by_element(dv, dv_p, dv_slack))


def sdpa_calls(a, B, H):
    """scaled_dot_product_attention (is_causal) on the same q, k, v as
    [B, H, T, D]: a forward call and a forward+backward call."""
    import torch
    import torch.nn.functional as F
    q, k, v = (a[n].reshape(B, H, *a[n].shape[1:]).detach().clone()
               .requires_grad_() for n in ("q", "k", "v"))
    do = a["do"].reshape(B, H, *a["do"].shape[1:])

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return torch.autograd.grad(out, (q, k, v), do)
    return fwd, fwd_bwd


LONG_T, LONG_H = 8192, 8


def bf16_long_context(mt, fa, rng, dev):
    """Phase 8 (see main); returns the sm90 kernels' launches on it and
    the local_attention forward+backward call, for timing."""
    import torch
    from mxtpu_torch.parallel import local_attention

    def bf16(D):
        return torch.from_numpy(rng.standard_normal(
            (1, LONG_H, LONG_T, D)).astype(np.float32)).to(dev).to(
                torch.bfloat16)

    def held(what, o, q, k, v, do=None, grads=None):
        """o (and grads of q, k, v under cotangent do) against the plain
        versions on the flattened inputs; returns the sm90 errors."""
        flat = [x.reshape(LONG_H, LONG_T, -1) for x in (q, k, v)]
        offs = torch.tensor([0.0, 0.0, LONG_T, 1.0 / np.sqrt(q.shape[-1])],
                            dtype=torch.float32, device=dev)
        o_p, lse_p = fa.flash_fwd_plain(*flat, offs, True)
        o = o.reshape(o_p.shape)
        # (without a backward, O stands in for the cotangent: only the dQ
        # allowance reads it)
        a = dict(q=flat[0], k=flat[1], v=flat[2], offs=offs, lse=lse_p,
                 do=o_p if do is None else do.reshape(o_p.shape))
        # the backward's delta, from the kernel's own O as autograd's
        a["delta"] = (a["do"].float() * o.float()).sum(-1)
        allowance = sm90_allowance(fa, a)
        excess = {"flash_fwd_sm90": sm90_excess(
            "flash_fwd_sm90", (o, lse_p), (o_p, lse_p), allowance)}
        errs = {"flash_fwd_sm90": max_err([o], [o_p])}
        if grads is not None:
            bw = (*flat, a["do"], lse_p, a["delta"], offs, True)
            dq_p = fa.flash_bwd_dq_plain(*bw)
            dq = grads[0].reshape(dq_p.shape)
            excess["flash_bwd_dq_sm90"] = sm90_excess(
                "flash_bwd_dq_sm90", (dq,), (dq_p,), allowance)
            errs["flash_bwd_dq_sm90"] = max_err([dq], [dq_p])
            dkv_p = fa.flash_bwd_dkv_plain(*bw)
            dkv = tuple(g.reshape(w.shape) for g, w in zip(grads[1:], dkv_p))
            excess["flash_bwd_dkv_sm90"] = sm90_excess(
                "flash_bwd_dkv_sm90", dkv, dkv_p, allowance)
            errs["flash_bwd_dkv_sm90"] = max_err(dkv, dkv_p)
        for name, x in excess.items():
            if x > 1.0:
                fail("%s: %s uses %.3g of its derived allowance"
                     % (what, name, x))
        return errs, excess

    # the op entry, on NDArrays on gpu(0)
    q, k, v = (mt.nd.array(bf16(64), ctx=mt.gpu(0)) for _ in range(3))
    fa.reset_launches()
    out = mt.nd.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    op_launches = dict(fa.LAUNCHES)
    want = {n: int(n == "flash_fwd_sm90") for n in fa.LAUNCHES}
    if op_launches != want or out.dtype != torch.bfloat16:
        fail("nd.flash_attention on bf16 launched %s (want %s), gave %s"
             % (op_launches, want, out.dtype))
    errs, excess = held("nd.flash_attention", out.data, q.data, k.data,
                        v.data)
    print("bf16 op entry: nd.flash_attention (1, %d, %d, 64) on %s: "
          "launches %s; max |out - plain| %s, share of allowance %s"
          % (LONG_H, LONG_T, out.context, op_launches,
             {n: "%.3g" % e for n, e in errs.items()},
             {n: "%.2f" % e for n, e in excess.items()}))

    # local_attention under autograd, forward and backward
    q, k, v = (bf16(128).requires_grad_() for _ in range(3))
    do = bf16(128)
    fa.reset_launches()
    o = local_attention(q, k, v, causal=True, impl="auto")
    grads = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    la_launches = dict(fa.LAUNCHES)
    want = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "flash_fwd_sm90": 1, "flash_bwd_dq_sm90": 1,
            "flash_bwd_dkv_sm90": 1}
    if la_launches != want:
        fail("local_attention bf16 forward+backward launched %s, want %s"
             % (la_launches, want))
    if not all(g.dtype == torch.bfloat16 and bool(torch.isfinite(
            g.float()).all()) for g in (o, *grads)):
        fail("local_attention bf16: outputs not finite bf16")
    errs, excess = held("local_attention", o.detach(), q.detach(),
                        k.detach(), v.detach(), do, grads)
    print("bf16 long context: local_attention (1, %d, %d, 128) causal on "
          "%s, forward and backward: launches %s; max |x - plain| %s, "
          "share of allowance %s"
          % (LONG_H, LONG_T, dev, la_launches,
             {n: "%.3g" % e for n, e in errs.items()},
             {n: "%.2f" % e for n, e in excess.items()}))

    def fwd_bwd():
        out = local_attention(q, k, v, causal=True, impl="auto")
        return torch.autograd.grad(out, (q, k, v), do)
    return {n: op_launches[n] + la_launches[n]
            for n in ("flash_fwd_sm90", "flash_bwd_dq_sm90",
                      "flash_bwd_dkv_sm90")}, fwd_bwd


# ---------------------------------------------------------------------------
# mx.rtc: the launch protocol, as the six launch cases of the JAX package's
# tests (tests/test_legacy_api.py) rewritten in CUDA C. dbl and rep are
# C++ kernels (launched under their lowered names), the rest extern "C".
# ---------------------------------------------------------------------------

RTC_SOURCE = r'''
extern "C" __global__ void axpy(const float *x, const float *y, float alpha,
                                float *out, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) out[i] = alpha * x[i] + y[i];
}

extern "C" __global__ void fill_rows(float *out, int cols) {
    // one program per grid point, as Pallas: blockIdx.x is program_id(0)
    for (int j = 0; j < cols; ++j) out[blockIdx.x * cols + j] = blockIdx.x;
}

__global__ void dbl(float *out, const float *x, int n) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = x[i] * 2.0f;
}

extern "C" __global__ void rows(float *out) {
    out[blockIdx.y] = blockIdx.y;       // grid (1, 3, 1): program_id(1)
}

extern "C" __global__ void scale(const float *x, float alpha, float *o,
                                 int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) o[i] = x[i] * alpha;
}

__global__ void rep(const float *x, int n, float *o, int size) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= size) return;
    float acc = x[i];
    for (int k = 1; k < n; ++k) acc += x[i];   // n is a run-time argument
    o[i] = acc;
}
'''
RTC_SIGNATURES = {
    "axpy": "const float *x, const float *y, float alpha, float *out, int n",
    "fill_rows": "float *out, int cols",
    "dbl": "float *out, const float *x, int n",
    "rows": "float *out",
    "scale": "const float *x, float alpha, float *o, int n",
    "rep": "const float *x, int n, float *o, int size",
}
# half through the toolkit's cuda_fp16.h, and dynamic shared memory
# above 48 KB (which needs cuFuncSetAttribute before the launch)
RTC_EXTRA_SOURCE = r'''
#include <cuda_fp16.h>
extern "C" __global__ void hscale(const __half *x, __half a, __half *o,
                                  int n) {
    int i = threadIdx.x;
    if (i < n) o[i] = __hmul(x[i], a);
}

extern "C" __global__ void smem_reverse(const float *x, float *o, int n) {
    extern __shared__ float buf[];
    for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = x[i];
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) o[i] = buf[n - 1 - i];
}
'''
RTC_SMEM_FLOATS = 16384                 # 64 KB of dynamic shared memory
# a kernel that does nothing: the card's cost of a launch, timed beside
# the head's kernels
EMPTY_SOURCE = 'extern "C" __global__ void empty(float *o) {}'
# the protocol cases compute small exact values; the card may contract
# alpha * x + y into one FMA, so allow a last-bit difference
RTC_TOL = dict(atol=1e-6, rtol=1e-6)


def rtc_axpy_plain(x, y, alpha):
    return alpha * x + y


def rtc_fill_rows_plain(rows, cols, device):
    import torch
    return torch.arange(rows, dtype=torch.float32,
                        device=device)[:, None].expand(rows, cols).clone()


def rtc_dbl_plain(x):
    return x * 2.0


def rtc_rows_plain(n, device):
    import torch
    return torch.arange(n, dtype=torch.float32, device=device)[None]


def rtc_scale_plain(x, alpha):
    return x * alpha


def rtc_rep_plain(x, n):
    acc = x.clone()
    for _ in range(n - 1):
        acc = acc + x
    return acc


def rtc_phase(mt):
    """The six launch cases on cuda:0 against their plain versions; one
    compile across new scalars and shapes; a float64 output behind
    ``float *`` comes back converted; a syntax error raises with NVRTC's
    log; a cpu() context raises. Returns the module."""
    import torch
    ctx, dev = mt.gpu(0), torch.device("cuda", 0)
    mod = mt.rtc.CudaModule(RTC_SOURCE)
    k = {n: mod.get_kernel(n, s) for n, s in RTC_SIGNATURES.items()}
    nd = mt.nd

    def held(name, got, want):
        torch.cuda.synchronize()
        if tuple(got.shape) != tuple(want.shape) or \
                not torch.allclose(got.float(), want.float(), **RTC_TOL):
            fail("rtc %s: %s differs from the plain version %s"
                 % (name, got.cpu().numpy(), want.cpu().numpy()))

    x = nd.array(np.arange(8, dtype=np.float32).reshape(2, 4), ctx=ctx)
    y, out = nd.ones((2, 4), ctx=ctx), nd.zeros((2, 4), ctx=ctx)
    k["axpy"].launch((x, y, 3.0, out, 8), ctx, (1, 1, 1), (8, 1, 1))
    held("axpy", out.data, rtc_axpy_plain(x.data, y.data, 3.0))
    out = nd.zeros((3, 4), ctx=ctx)
    k["fill_rows"].launch((out, 4), ctx, (3, 1, 1))
    held("fill_rows", out.data, rtc_fill_rows_plain(3, 4, dev))
    x, out = nd.array(np.arange(4, dtype=np.float32), ctx=ctx), \
        nd.zeros((4,), ctx=ctx)
    k["dbl"].launch((out, x, 4), ctx, (1, 1, 1), (32, 1, 1))
    held("dbl", out.data, rtc_dbl_plain(x.data))
    out = nd.zeros((1, 3), ctx=ctx)
    k["rows"].launch((out,), ctx, (1, 3, 1))
    held("rows", out.data, rtc_rows_plain(3, dev))
    x = nd.ones((4,), ctx=ctx)
    for alpha in (1.0, 2.0, 3.0):
        o = nd.zeros((4,), ctx=ctx)
        k["scale"].launch((x, alpha, o, 4), ctx, (1, 1, 1), (4, 1, 1))
        held("scale alpha=%g" % alpha, o.data, rtc_scale_plain(x.data, alpha))
    o = nd.zeros((4,), ctx=ctx)
    for n in (3, 5):
        k["rep"].launch((x, n, o, 4), ctx, (1, 1, 1), (4, 1, 1))
        held("rep n=%d" % n, o.data, rtc_rep_plain(x.data, n))
    # a new shape and new scalar values compile nothing
    big = nd.array(np.arange(1000, dtype=np.float32), ctx=ctx)
    o = nd.zeros((1000,), ctx=ctx)
    k["scale"].launch((big, 0.5, o, 1000), ctx, (4, 1, 1), (256, 1, 1))
    held("scale n=1000", o.data, rtc_scale_plain(big.data, 0.5))
    if mod.compiles != 1:
        fail("the rtc module compiled %d times, want once" % mod.compiles)
    # a float64 output behind float *out: converted in and back out
    x64 = nd.array(np.arange(4, dtype=np.float32), ctx=ctx)
    out64 = nd.zeros((4,), ctx=ctx, dtype="float64")
    k["dbl"].launch((out64, x64, 4), ctx, (1, 1, 1), (4, 1, 1))
    held("dbl into float64", out64.data, rtc_dbl_plain(x64.data).double())
    if out64.dtype != np.float64:
        fail("a float64 output came back as %s" % out64.dtype)
    # half scalars and arrays through the toolkit's cuda_fp16.h; 64 KB
    # of dynamic shared memory
    extra = mt.rtc.CudaModule(RTC_EXTRA_SOURCE)
    xh = nd.array(np.linspace(-2, 2, 8), ctx=ctx, dtype="float16")
    oh = nd.zeros((8,), ctx=ctx, dtype="float16")
    extra.get_kernel("hscale", "const half *x, half a, half *o, int n") \
        .launch((xh, 1.5, oh, 8), ctx, (1, 1, 1), (8, 1, 1))
    held("hscale (half)", oh.data, xh.data * 1.5)
    n = RTC_SMEM_FLOATS
    xs = nd.array(np.arange(n, dtype=np.float32), ctx=ctx)
    os_ = nd.zeros((n,), ctx=ctx)
    extra.get_kernel("smem_reverse", "const float *x, float *o, int n") \
        .launch((xs, os_, n), ctx, (1, 1, 1), (256, 1, 1), shared_mem=4 * n)
    held("smem_reverse (64 KB shared)", os_.data, xs.data.flip(0))
    # a compile error carries NVRTC's log
    broken = mt.rtc.CudaModule('extern "C" __global__ void broken(float *o)'
                               ' { o[0] = ; }')
    try:
        broken.get_kernel("broken", "float *o").launch(
            (nd.zeros((1,), ctx=ctx),), ctx)
        fail("a source with a syntax error launched")
    except mt.MXTPUError as e:
        if "error" not in str(e) or "broken" not in str(e):
            fail("the compile error does not carry NVRTC's log: %s" % e)
        log_line = [ln for ln in str(e).splitlines() if "error" in ln][0]
    # CUDA C runs only on a gpu context
    try:
        k["dbl"].launch((nd.zeros((4,), ctx=mt.cpu()),
                         nd.zeros((4,), ctx=mt.cpu()), 4), mt.cpu())
        fail("a launch on cpu() ran")
    except mt.MXTPUError:
        pass
    print("rtc: six launch cases match their plain versions (tolerance %s); "
          "%d compile (%.1f ms) across alphas 1-3, n 3 and 5 and a new "
          "shape; float64 output converted; half through cuda_fp16.h; "
          "64 KB of dynamic shared memory; "
          "compile error raises (%s); "
          "cpu() raises" % (RTC_TOL, mod.compiles, mod.compile_ms,
                            log_line.strip()[:80]))
    return mod


# ---------------------------------------------------------------------------
# the custom-op slice: the MLP of example/numpy-ops/custom_softmax.py at its
# own widths, its softmax-with-loss head a CustomOp whose kernels are
# CUDA C compiled by mx.rtc on the card (cs_*), and plain torch on the CPU
# ---------------------------------------------------------------------------

CS_IN, CS_HIDDEN, CS_CLASSES, CS_SAMPLES, CS_BATCH = 784, 128, 10, 2048, 128
CS_EPOCHS, CS_LR, CS_MOMENTUM = 4, 0.1, 0.9
CS_STEPS = CS_EPOCHS * CS_SAMPLES // CS_BATCH
CS_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)
CS_REQUEST_ROWS = (1, 7, 32, 128, 100, 3)
# the LSTM LM's output, (32 x 32 tokens, vocab 10,000), as rows: the shape
# where the head kernels move enough bytes for memory to bound them
CS_BIG = (1024, VOCAB)

# The head's kernels (replace mxtpu/rtc.py's PallasKernel.launch, which
# runs a user's kernel body compiled at run time). Memory bounds both: a
# few flops an element against 8 bytes moved.
# cs_softmax_fwd reads x once and writes y once, by the row's width
# (cols, uniform over the grid):
#   - cols <= 32: a group of G lanes a row (G the power of 2 >= cols), 32/G
#     rows a warp, blockDim/G rows a block: max and sum by shuffles
#     within the group, y = e / sum;
#   - 32 < cols <= 4 * CS_VEC * blockDim (32,768 columns at 1,024
#     threads): one block a row, held in registers, CS_VEC float4s a
#     thread (scalars before the first 16-byte boundary and after the
#     last), every load in flight before the first use; each thread's
#     (max, sum of exp) pair is merged by shuffles and one exchange in
#     shared memory, then y = exp(x - m_thread) * exp(m_thread - m) / sum,
#     stored as float4 where y's row has x's alignment;
#   - wider rows: an online (max, sum) pass and a second read of x to
#     write y, as the kernel this one replaced did for every width.
# cs_softmax_bwd: dx = y - onehot(label), one thread per element
# (need_top_grad=False).
# the float4s a thread of cs_softmax_fwd's held path holds: the source's
# CS_VEC and its launch geometry (cs_softmax_fwd_dims)
CS_VEC = 8
CS_SOURCE = "#define CS_VEC %d\n" % CS_VEC + r"""
#define CS_NEG_INF __int_as_float(0xff800000)
#define CS_FULL 0xffffffffu

__device__ __forceinline__ void cs_merge(float &m, float &s, float m2,
                                         float s2) {
    float mm = fmaxf(m, m2);
    if (mm == CS_NEG_INF) return;            // both partials empty
    s = s * expf(m - mm) + s2 * expf(m2 - mm);
    m = mm;
}

// (max, sum of exp) over a block: shuffles within each warp, one
// exchange through shared memory, then every warp merges the warps'
// partials itself, so no second barrier is needed
__device__ __forceinline__ void cs_merge_block(float &m, float &s) {
    __shared__ float wm[32], ws[32];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nw = (blockDim.x + 31) >> 5;
    for (int o = 16; o > 0; o >>= 1)
        cs_merge(m, s, __shfl_xor_sync(CS_FULL, m, o),
                 __shfl_xor_sync(CS_FULL, s, o));
    if (lane == 0) { wm[warp] = m; ws[warp] = s; }
    __syncthreads();
    m = lane < nw ? wm[lane] : CS_NEG_INF;
    s = lane < nw ? ws[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1)
        cs_merge(m, s, __shfl_xor_sync(CS_FULL, m, o),
                 __shfl_xor_sync(CS_FULL, s, o));
}

// rows of <= G columns (G a power of 2), a group of G lanes a row: the
// shuffle widths are compile-time constants, so both reductions unroll
template <int G>
__device__ __forceinline__ void cs_narrow(const float *__restrict__ x,
                                          float *__restrict__ y, int rows,
                                          int cols) {
    const int r = blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
    const int j = threadIdx.x & (G - 1);
    const bool live = r < rows && j < cols;
    const long long at = (long long)r * cols + j;
    const float v = live ? x[at] : CS_NEG_INF;
    float m = v;
#pragma unroll
    for (int o = G / 2; o > 0; o /= 2)
        m = fmaxf(m, __shfl_xor_sync(CS_FULL, m, o));
    const float e = live ? expf(v - m) : 0.f;
    float s = e;
#pragma unroll
    for (int o = G / 2; o > 0; o /= 2) s += __shfl_xor_sync(CS_FULL, s, o);
    if (live) y[at] = e / s;
}

extern "C" __global__ void __launch_bounds__(1024)
cs_softmax_fwd(const float *__restrict__ x, float *__restrict__ y, int rows,
               int cols) {
    const int tid = threadIdx.x, nt = blockDim.x;
    if (cols <= 32) {
        if (cols <= 2) {
            if (cols <= 1) cs_narrow<1>(x, y, rows, cols);
            else cs_narrow<2>(x, y, rows, cols);
        } else if (cols <= 8) {
            if (cols <= 4) cs_narrow<4>(x, y, rows, cols);
            else cs_narrow<8>(x, y, rows, cols);
        } else {
            if (cols <= 16) cs_narrow<16>(x, y, rows, cols);
            else cs_narrow<32>(x, y, rows, cols);
        }
        return;
    }
    const float *xr = x + (long long)blockIdx.x * cols;
    float *yr = y + (long long)blockIdx.x * cols;
    if (cols <= 4 * CS_VEC * nt) {
        const int head = (int)((16 - ((unsigned long long)xr & 15)) & 15) >> 2;
        const int n4 = (cols - head) >> 2, tail = cols - head - 4 * n4;
        const float4 *x4 = reinterpret_cast<const float4 *>(xr + head);
        float4 v[CS_VEC];
#pragma unroll
        for (int k = 0; k < CS_VEC; ++k) {
            const int i = tid + k * nt;
            v[k] = i < n4 ? x4[i] : make_float4(CS_NEG_INF, CS_NEG_INF,
                                                CS_NEG_INF, CS_NEG_INF);
        }
        float hv = tid < head ? xr[tid] : CS_NEG_INF;
        float tv = tid < tail ? xr[head + 4 * n4 + tid] : CS_NEG_INF;
        float m = fmaxf(hv, tv);
#pragma unroll
        for (int k = 0; k < CS_VEC; ++k)
            m = fmaxf(m, fmaxf(fmaxf(v[k].x, v[k].y), fmaxf(v[k].z, v[k].w)));
        // held values become exp(x - m_thread); a thread with no finite
        // value keeps m = -inf and holds zeros
        const float base = m == CS_NEG_INF ? 0.f : m;
        hv = expf(hv - base);
        tv = expf(tv - base);
        float s = hv + tv;
#pragma unroll
        for (int k = 0; k < CS_VEC; ++k) {
            v[k].x = expf(v[k].x - base);
            v[k].y = expf(v[k].y - base);
            v[k].z = expf(v[k].z - base);
            v[k].w = expf(v[k].w - base);
            s += (v[k].x + v[k].y) + (v[k].z + v[k].w);
        }
        const float mine = m;
        cs_merge_block(m, s);
        const float c = expf(mine - m) * (1.f / s);
        float *yb = yr + head;
        if (((unsigned long long)yb & 15) == 0) {
            float4 *y4 = reinterpret_cast<float4 *>(yb);
#pragma unroll
            for (int k = 0; k < CS_VEC; ++k) {
                const int i = tid + k * nt;
                if (i < n4)
                    y4[i] = make_float4(v[k].x * c, v[k].y * c, v[k].z * c,
                                        v[k].w * c);
            }
        } else {                             // y's row sits off x's alignment
#pragma unroll
            for (int k = 0; k < CS_VEC; ++k) {
                const int i = tid + k * nt;
                if (i < n4) {
                    yb[4 * i] = v[k].x * c;
                    yb[4 * i + 1] = v[k].y * c;
                    yb[4 * i + 2] = v[k].z * c;
                    yb[4 * i + 3] = v[k].w * c;
                }
            }
        }
        if (tid < head) yr[tid] = hv * c;
        if (tid < tail) yb[4 * n4 + tid] = tv * c;
        return;
    }
    float m = CS_NEG_INF, s = 0.f;
    for (int j = tid; j < cols; j += nt) {
        const float v = xr[j];
        if (v > m) { s = s * expf(m - v) + 1.f; m = v; }
        else s += expf(v - m);
    }
    cs_merge_block(m, s);
    const float inv = 1.f / s;
    for (int j = tid; j < cols; j += nt) yr[j] = expf(xr[j] - m) * inv;
}

extern "C" __global__ void cs_softmax_bwd(const float *__restrict__ y,
                                          const float *__restrict__ label,
                                          float *__restrict__ dx, int rows,
                                          int cols) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= rows * cols) return;
    int r = i / cols, c = i - r * cols;
    dx[i] = y[i] - (c == (int)label[r] ? 1.f : 0.f);
}
"""
CS_SIGNATURES = {
    "cs_softmax_fwd": "const float *x, float *y, int rows, int cols",
    "cs_softmax_bwd": "const float *y, const float *label, float *dx, "
                      "int rows, int cols",
}
# the block of cs_softmax_fwd's narrow path
CS_NARROW_BLOCK = 128
# Head kernels vs plain on the card (f32): the same exp, max and sum in
# another order (and y = e * (1/sum) against e / sum): a few ulps of
# values <= 1.
CS_KERNEL_TOL = dict(atol=1e-6, rtol=0)
# The MLP's first steps, card vs CPU: f32 GEMMs (TF32 off) and sums in
# another order; SGD moves each weight by lr/128 times its gradient.
CS_TOL = dict(atol=1e-5, rtol=1e-5)
CS_SERVE_TOL = dict(atol=1e-6, rtol=1e-3)

_CS = {}


def cs_module():
    """The head's rtc module (compiled at its first launch)."""
    if not _CS:
        import mxtpu_torch as mt
        _CS["module"] = mt.rtc.CudaModule(CS_SOURCE)
        _CS["kernels"] = {n: _CS["module"].get_kernel(n, s)
                          for n, s in CS_SIGNATURES.items()}
    return _CS["module"]


def cs_kernels():
    """The head's two rtc kernels by name."""
    cs_module()
    return _CS["kernels"]


def cs_softmax_fwd_dims(rows, cols):
    """(grid, block) of cs_softmax_fwd, by the kernel's three paths: rows of
    <= 32 columns a lane group each, CS_NARROW_BLOCK threads a block; else
    a block a row with enough threads that CS_VEC float4s each hold it
    (1,024 threads past 32,768 columns, where the two-pass loop runs)."""
    if cols <= 32:
        per_block = CS_NARROW_BLOCK >> (cols - 1).bit_length()
        return -(-rows // per_block), CS_NARROW_BLOCK
    return rows, min(1024, 32 * -(-cols // (4 * CS_VEC * 32)))


def cs_softmax_fwd(x, y):
    """Launch cs_softmax_fwd: y <- softmax(x) by rows; x, y (rows, cols)
    float32 NDArrays on a gpu context."""
    rows, cols = x.shape
    grid, block = cs_softmax_fwd_dims(rows, cols)
    cs_kernels()["cs_softmax_fwd"].launch((x, y, rows, cols), x.context,
                                          (grid, 1, 1), (block, 1, 1))


def cs_softmax_bwd(y, label, dx):
    """Launch cs_softmax_bwd: dx <- y - onehot(label)."""
    rows, cols = y.shape
    cs_kernels()["cs_softmax_bwd"].launch(
        (y, label, dx, rows, cols), y.context,
        ((rows * cols + 255) // 256, 1, 1), (256, 1, 1))


def cu_func_attrs(function):
    """(registers, local memory bytes) a thread of a CUfunction, from
    libcuda's cuFuncGetAttribute: local memory above 0 means spills."""
    import ctypes
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuFuncGetAttribute.argtypes = (ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_void_p)
    out = []
    for attr in (4, 3):     # CU_FUNC_ATTRIBUTE_NUM_REGS, _LOCAL_SIZE_BYTES
        v = ctypes.c_int()
        res = lib.cuFuncGetAttribute(ctypes.byref(v), attr, function)
        if res != 0:
            fail("cuFuncGetAttribute(%d) failed with CUresult %d"
                 % (attr, res))
        out.append(v.value)
    return tuple(out)


def cs_softmax_fwd_plain(x):
    e = (x - x.amax(1, keepdim=True)).exp()
    return e / e.sum(1, keepdim=True)


def cs_softmax_bwd_plain(y, label):
    import torch
    dx = y.clone()
    dx[torch.arange(y.shape[0], device=y.device), label.long()] -= 1.0
    return dx


def cs_register(mt):
    """Register the head as custom op type "softmax" of mt.operator, as
    the example registers its numpy op with mxtpu: the rtc kernels on a
    gpu context, their plain versions on the CPU."""

    class Softmax(mt.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0]
            if x.context.device_type == "gpu":
                y = mt.nd.empty(x.shape, ctx=x.context)
                cs_softmax_fwd(x, y)
            else:
                y = cs_softmax_fwd_plain(x.data)
            self.assign(out_data[0], req[0], y)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y, label = out_data[0], in_data[1]
            if y.context.device_type == "gpu":
                dx = mt.nd.empty(y.shape, ctx=y.context)
                cs_softmax_bwd(y, label, dx)
            else:
                dx = cs_softmax_bwd_plain(y.data, label.data)
            self.assign(in_grad[0], req[0], dx)

    register_softmax_prop(mt, "softmax", Softmax)


# The custom ops of host_read_register: how each body meets a capture.
HOST_READS = {
    # the example's asnumpy: torch refuses the copy before CUDA sees it
    "softmax_host": "copy",
    # wait_to_read first: CUDA refuses the wait and fails the capture
    "softmax_wait": "wait",
    # an error of the op's own, raised only while a capture is under way
    "softmax_fault": "fault",
}


def host_read_register(mt, op_type="softmax_host"):
    """Register custom op ``op_type`` of HOST_READS: the example's numpy
    op itself (example/numpy-ops/custom_softmax.py) written for the port,
    whose Python body reads its inputs back to the host (asnumpy), so a
    CUDA graph cannot hold it."""
    import torch
    read = HOST_READS[op_type]

    class Softmax(mt.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            if read == "wait":
                in_data[0].wait_to_read()
            if read == "fault" and torch.cuda.is_current_stream_capturing():
                raise ValueError("softmax_fault: a fault of the op's own")
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1).reshape((x.shape[0], 1)))
            y /= y.sum(axis=1).reshape((x.shape[0], 1))
            self.assign(out_data[0], req[0], mt.nd.array(y))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = in_data[1].asnumpy().ravel().astype(int)
            y = out_data[0].asnumpy()
            y[np.arange(lab.shape[0]), lab] -= 1.0
            self.assign(in_grad[0], req[0], mt.nd.array(y))

    register_softmax_prop(mt, op_type, Softmax)


def register_softmax_prop(mt, op_type, op_class):
    """Register the example's softmax-with-loss signature as ``op_type``,
    made by ``op_class``."""

    @mt.operator.register(op_type)
    class SoftmaxProp(mt.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def infer_type(self, in_type):
            return in_type, [in_type[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return op_class()


def cs_symbol(pkg, op_type="softmax"):
    """The example's net, in either package."""
    data = pkg.sym.var("data")
    net = pkg.sym.FullyConnected(data, name="fc1", num_hidden=CS_HIDDEN)
    net = pkg.sym.Activation(net, name="relu1", act_type="relu")
    net = pkg.sym.FullyConnected(net, name="fc2", num_hidden=CS_CLASSES)
    return pkg.sym.Custom(net, pkg.sym.var("softmax_label"), name="softmax",
                          op_type=op_type)


def cs_data():
    """The example's 2048 samples: RandomState(0), prototypes + 0.25
    noise; (x float32 (2048, 784), y float32 (2048,))."""
    r = np.random.RandomState(0)
    y = r.randint(0, CS_CLASSES, CS_SAMPLES)
    protos = r.uniform(0, 1, (CS_CLASSES, CS_IN)).astype(np.float32)
    x = (protos[y] + 0.25 * r.randn(CS_SAMPLES, CS_IN)).astype(np.float32)
    return x, y.astype(np.float32)


def cs_init_params(seed):
    """mxtpu Module's default init (Uniform(0.01) weights, zero biases),
    drawn from ``seed`` with numpy."""
    rng = np.random.RandomState(seed)
    shapes = {"fc1_weight": (CS_HIDDEN, CS_IN), "fc1_bias": (CS_HIDDEN,),
              "fc2_weight": (CS_CLASSES, CS_HIDDEN),
              "fc2_bias": (CS_CLASSES,)}
    return {k: (rng.uniform(-0.01, 0.01, s) if k.endswith("weight")
                else np.zeros(s)).astype(np.float32)
            for k, s in shapes.items()}


def cs_batches(seed):
    """Index arrays of the 64 batches: each epoch a permutation from
    ``seed``, cut into 16 batches of 128 (NDArrayIter's shuffle)."""
    rng = np.random.RandomState(seed)
    return [perm[i:i + CS_BATCH]
            for perm in (rng.permutation(CS_SAMPLES)
                         for _ in range(CS_EPOCHS))
            for i in range(0, CS_SAMPLES, CS_BATCH)]


def cs_step(mt, sym, params, moms, x, y):
    """One training step on NDArrays: the graph's forward through
    symbol.eval_graph(training=True) under autograd.record(), backward
    into the params' grads, then momentum SGD as mxtpu's SGD does it
    (Module.fit's rescale_grad = 1/batch). Returns the head's output."""
    import torch
    with mt.autograd.record():
        feed = {k: p.data for k, p in params.items()}
        feed.update(data=x.data, softmax_label=y.data)
        outs, _ = mt.sym.eval_graph(sym._outputs, feed, training=True)
        out = mt.nd.NDArray(outs[0], x.context)
    mt.autograd.backward([out])
    with torch.no_grad():
        for k, p in params.items():
            g = p.grad.data * (1.0 / x.shape[0])
            moms[k].mul_(CS_MOMENTUM).sub_(CS_LR * g)
            p.data.add_(moms[k])
    return out


def cs_train(mt, params0, xs, ys, batches):
    """Momentum SGD from ``params0`` (numpy) over ``batches`` of the
    samples ``xs``, ``ys`` (NDArrays on the training context). Returns
    (params as NDArrays, per-step losses as a tensor)."""
    import torch
    ctx = xs.context
    sym = cs_symbol(mt)
    params = {k: mt.nd.array(v, ctx=ctx) for k, v in params0.items()}
    for p in params.values():
        p.attach_grad()
    moms = {k: torch.zeros_like(p.data) for k, p in params.items()}
    losses = []
    for idx in batches:
        sel = torch.from_numpy(idx).to(xs.data.device)
        x = mt.nd.NDArray(xs.data[sel], ctx)
        y = mt.nd.NDArray(ys.data[sel], ctx)
        out = cs_step(mt, sym, params, moms, x, y)
        with torch.no_grad():
            p = out.data.gather(1, y.data.long()[:, None])
            losses.append(-p.clamp_min(1e-30).log().mean())
    return params, torch.stack(losses)


def cs_accuracy(mt, params, xs, y_all):
    """Train accuracy of ``params`` over the samples ``xs`` (an NDArray)
    against the labels ``y_all`` (numpy); forward only."""
    import torch
    sym = cs_symbol(mt)
    feed = {k: p.data.detach() for k, p in params.items()}
    feed.update(data=xs.data, softmax_label=torch.zeros(
        xs.shape[0], device=xs.data.device))
    with torch.no_grad():
        out, _ = mt.sym.eval_graph(sym._outputs, feed)
    pred = out[0].argmax(1).cpu().numpy()
    return float((pred == y_all).mean())


def cs_bound(name, rows, cols):
    """Least time (ms): each input read once and each output written once
    at the HBM rate (the arithmetic, a few flops an element, is far
    below the f32 rate)."""
    elems = rows * cols
    nbytes = 2 * elems * 4 if name == "cs_softmax_fwd" \
        else (2 * elems + rows) * 4
    flops = 5 * elems if name == "cs_softmax_fwd" else elems
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")



# ---------------------------------------------------------------------------
# the Module.fit slice: the two examples' own training calls through
# mx.mod.Module(...).fit(...) on the port: the custom-softmax MLP of
# example/numpy-ops/custom_softmax.py (its head launching cs_softmax_fwd and
# cs_softmax_bwd every step) and LeNet of
# example/image-classification/train_mnist.py --network lenet (BASELINE.json
# config 1), whose Convolution, Pooling and FullyConnected run on cuDNN and
# cuBLAS through torch
# ---------------------------------------------------------------------------

LENET_SAMPLES, LENET_VAL, LENET_BATCH, LENET_EPOCHS = 2000, 500, 64, 3
LENET_LR, LENET_MOMENTUM = 0.05, 0.9
# Validation accuracy LeNet must reach on the card: train_mnist.py --network
# lenet run by mxtpu on the CPU scores 1.000 on its 500 synthetic validation
# digits (from epoch 0 on); the margin allows ten of them wrong.
LENET_MIN_ACC = 1.0 - 0.02
# The first steps of Module.fit, card vs CPU, f32 (TF32 off): the GEMMs and
# convolutions sum at most 800 products in another order, a relative error
# of at most 800 x 2^-24 = 4.8e-5 of a gradient element, and SGD moves a
# weight by lr / batch times its gradient (momentum adds at most the two
# earlier steps), less than 0.1 in 3 steps here: below 1e-5 of a weight. On
# the CPU the port's Module.fit ends an epoch within 3e-8 of mxtpu's.
FIT_TOL = dict(atol=1e-5, rtol=1e-5)
FIT_STEPS = 3


def lenet_symbol(pkg):
    """train_mnist.py's get_lenet in either package, built in a fresh name
    scope so that both give the parameters the same names."""
    with pkg.name.NameManager():
        data = pkg.sym.var("data")
        conv1 = pkg.sym.Convolution(data, kernel=(5, 5), num_filter=20)
        tanh1 = pkg.sym.Activation(conv1, act_type="tanh")
        pool1 = pkg.sym.Pooling(tanh1, pool_type="max", kernel=(2, 2),
                                stride=(2, 2))
        conv2 = pkg.sym.Convolution(pool1, kernel=(5, 5), num_filter=50)
        tanh2 = pkg.sym.Activation(conv2, act_type="tanh")
        pool2 = pkg.sym.Pooling(tanh2, pool_type="max", kernel=(2, 2),
                                stride=(2, 2))
        flat = pkg.sym.Flatten(pool2)
        fc1 = pkg.sym.FullyConnected(flat, num_hidden=500)
        tanh3 = pkg.sym.Activation(fc1, act_type="tanh")
        fc2 = pkg.sym.FullyConnected(tanh3, num_hidden=10)
        return pkg.sym.SoftmaxOutput(fc2, name="softmax")


def lenet_data():
    """train_mnist.py's synthetic digits (used when no MNIST files are
    present, as in this repository): RandomState(0), 2,000 images 1x28x28
    of noise below 0.1 with a 3x3 block of +0.9 at (2c, 2c) for class c;
    the first 500 again as validation. (tr_x, tr_y, va_x, va_y)."""
    rng = np.random.RandomState(0)
    tr_y = rng.randint(0, 10, LENET_SAMPLES).astype(np.float32)
    tr_x = rng.rand(LENET_SAMPLES, 1, 28, 28).astype(np.float32) * 0.1
    for i in range(LENET_SAMPLES):
        c = int(tr_y[i])
        tr_x[i, 0, c * 2:c * 2 + 3, c * 2:c * 2 + 3] += 0.9
    return tr_x, tr_y, tr_x[:LENET_VAL], tr_y[:LENET_VAL]


def lenet_init_params(mt, seed):
    """LeNet's weights as Module.fit draws them (Xavier weights, zero
    biases) with the port's initializer from ``seed`` on the CPU; {name:
    numpy}."""
    mt.random.seed(seed)
    mod = mt.mod.Module(lenet_symbol(mt), context=mt.cpu())
    mod.bind([("data", (LENET_BATCH, 1, 28, 28))],
             [("softmax_label", (LENET_BATCH,))])
    mod.init_params(mt.init.Xavier())
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def host_params(pkg, params):
    """{name: numpy} as NDArrays on the CPU of ``pkg`` (None stays)."""
    if params is None:
        return None
    return {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in params.items()}


def mlp_fit(pkg, x, y, context=None, arg_params=None, num_epoch=CS_EPOCHS,
            shuffle=True):
    """custom_softmax.py's main through Module.fit in either package: its
    seeds, iterator, Module and fit call (on the current context unless
    ``context``), optionally from given weights ({name: numpy}). Returns
    (module, iterator)."""
    np.random.seed(0)       # NDArrayIter shuffles with numpy's global RNG
    pkg.random.seed(5)
    train = pkg.io.NDArrayIter(x, y, CS_BATCH, shuffle=shuffle,
                               label_name="softmax_label")
    where = {} if context is None else {"context": context}
    mod = pkg.mod.Module(cs_symbol(pkg), data_names=("data",),
                         label_names=("softmax_label",), **where)
    mod.fit(train, optimizer="sgd",
            optimizer_params={"learning_rate": CS_LR,
                              "momentum": CS_MOMENTUM},
            eval_metric="acc", num_epoch=num_epoch,
            arg_params=host_params(pkg, arg_params))
    return mod, train


def lenet_fit(pkg, data, context=None, arg_params=None,
              num_epoch=LENET_EPOCHS, shuffle=True, validate=True,
              kvstore=None):
    """train_mnist.py --network lenet's main through Module.fit in either
    package: a local kvstore object (so the optimizer runs at the store),
    or ``kvstore`` as given ("local", fit's default, means no store on one
    device: the module's Updater runs, and the fused step may engage),
    Xavier, SGD lr 0.05 / momentum 0.9, Speedometer(64, 50), the
    validation set scored each epoch; on the current context unless
    ``context``, optionally from given weights ({name: numpy}). ``data``
    is (train x, train y, validation x, validation y) for NDArrayIters,
    or the (train, validation) iterators themselves. Returns (module,
    train iterator, validation iterator)."""
    if len(data) == 2:
        train, val = data
    else:
        tr_x, tr_y, va_x, va_y = data
        train = pkg.io.NDArrayIter(tr_x, tr_y, LENET_BATCH, shuffle=shuffle)
        val = pkg.io.NDArrayIter(va_x, va_y, LENET_BATCH)
    kv = pkg.kv.create("local") if kvstore is None else kvstore
    mod = pkg.mod.Module(lenet_symbol(pkg),
                         context=context or pkg.context.current_context())
    mod.fit(train, eval_data=val if validate else None, kvstore=kv,
            optimizer="sgd",
            optimizer_params={"learning_rate": LENET_LR,
                              "momentum": LENET_MOMENTUM},
            initializer=pkg.init.Xavier(), num_epoch=num_epoch,
            batch_end_callback=pkg.callback.Speedometer(LENET_BATCH, 50),
            arg_params=host_params(pkg, arg_params))
    return mod, train, val


def module_params(mod):
    """A Module's arg params as {name: numpy}."""
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def clocked(clock, phase, fn, *a):
    """``fn(*a)``, its host seconds added to ``clock[phase]`` (``clock``
    None: not counted)."""
    t0 = time.perf_counter()
    out = fn(*a)
    if clock is not None:
        clock[phase] = clock.get(phase, 0.0) + time.perf_counter() - t0
    return out


def fit_steps(mod, data_iter, metric, steps=None, batch=None, clock=None,
              per_bucket=None):
    """Module.fit's loop body (forward_backward, update, the next batch
    drawn and staged, update_metric) on a bound, initialized module, from
    where ``data_iter`` stands (``batch``: the batch already drawn, if
    any). ``steps`` None runs to the iterator's end; a number of steps
    resets the iterator at an epoch's end (inside "next batch") and goes
    on. ``clock`` ({phase: seconds}) gathers the host time of each phase;
    ``per_bucket`` ({bucket key: [ms]}) the host time of each step,
    forward_backward to update_metric. Returns (the next batch drawn, or
    None at the iterator's end; the steps run)."""
    def timed(phase, fn, *a):
        return clocked(clock, phase, fn, *a)

    def draw():
        try:
            return data_iter.next()
        except StopIteration:
            if steps is None:
                return None
        data_iter.reset()
        return data_iter.next()
    if batch is None:
        batch = timed("next batch", draw)
    run = 0
    while batch is not None and run != steps:
        t0 = time.perf_counter()
        timed("forward_backward", mod.forward_backward, batch)
        timed("update", mod.update)
        upcoming = timed("next batch", draw)
        if upcoming is not None:
            timed("prepare", mod.prepare, upcoming)
        timed("update_metric", mod.update_metric, metric, batch.label)
        if per_bucket is not None:
            per_bucket.setdefault(batch.bucket_key, []).append(
                (time.perf_counter() - t0) * 1e3)
        batch = upcoming
        run += 1
    return batch, run


def fit_epoch(mod, data_iter, metric, clock=None, per_bucket=None):
    """One epoch of fit_steps from a reset; returns the steps run."""
    data_iter.reset()
    return fit_steps(mod, data_iter, metric, clock=clock,
                     per_bucket=per_bucket)[1]


def module_fit_phase(mt, seed, workdir):
    """Both examples through Module.fit on cuda:0 with the eager step (run
    under MXTPU_MODULE_FUSED=0; LeNet's kvstore object keeps it eager in
    any case): the checks. Returns {"MLP": (module, train iterator)}."""
    import logging
    import torch
    gpu = mt.gpu(0)
    logging.basicConfig(level=logging.INFO, format="  %(message)s",
                        stream=sys.stdout, force=True)
    ck = cs_kernels()
    x_all, y_all = cs_data()
    # the MLP's first steps from the same weights and batches: the card's
    # Module, the CPU's Module, and the hand-written loop it replaces
    cs_p0 = cs_init_params(seed)
    first = cs_batches(seed)[:FIT_STEPS]
    idx = np.concatenate(first)
    got = {ctx: module_params(mlp_fit(mt, x_all[idx], y_all[idx], ctx,
                                      cs_p0, 1, shuffle=False)[0])
           for ctx in (gpu, mt.cpu())}
    loop, _ = cs_train(mt, cs_p0, mt.nd.array(x_all, ctx=gpu),
                       mt.nd.array(y_all, ctx=gpu), first)
    loop = {k: v.asnumpy() for k, v in loop.items()}
    names = sorted(cs_p0)
    for what, want in (("the CPU's Module", got[mt.cpu()]),
                       ("cs_train on the card", loop)):
        check_close("MLP Module.fit after %d steps on the card vs %s"
                    % (FIT_STEPS, what),
                    [torch.from_numpy(got[gpu][k]) for k in names],
                    [torch.from_numpy(want[k]) for k in names], CS_TOL)
    print("Module.fit MLP: %d steps on the card vs the CPU's Module: max "
          "|diff| %.3g; vs cs_train: %.3g (tolerance %s)"
          % (FIT_STEPS, max(np.abs(got[gpu][k] - got[mt.cpu()][k]).max()
                            for k in names),
             max(np.abs(got[gpu][k] - loop[k]).max() for k in names),
             CS_TOL))

    # the example itself: 4 epochs on the current context (gpu(0)), then
    # its train accuracy by score; each training step launches each head
    # kernel once, each scored batch the forward once
    for kern in ck.values():
        kern.launches = 0
    t0 = time.perf_counter()
    mlp, train = mlp_fit(mt, x_all, y_all)
    torch.cuda.synchronize()
    mlp_s = time.perf_counter() - t0
    fit_launches = {n: kern.launches for n, kern in ck.items()}
    for kern in ck.values():
        kern.launches = 0
    acc = dict(mlp.score(train, "acc"))["accuracy"]
    score_launches = {n: kern.launches for n, kern in ck.items()}
    batches = CS_SAMPLES // CS_BATCH
    if mlp._context != [gpu]:
        fail("Module's context is %s, not gpu(0)" % mlp._context)
    for name, n in fit_launches.items():
        if n != CS_STEPS:
            fail("%s launched %d times in %d Module.fit steps, want one a "
                 "step" % (name, n, CS_STEPS))
    if score_launches != {"cs_softmax_fwd": batches, "cs_softmax_bwd": 0}:
        fail("score over %d batches launched %s" % (batches, score_launches))
    if not acc > 0.9:
        fail("the custom-softmax MLP trained by Module.fit scores train "
             "accuracy %.4f (the example asserts > 0.9)" % acc)
    print("Module.fit MLP (custom_softmax.py's call, context %s): %d epochs, "
          "%d steps in %.3f s; train accuracy %.4f (limit 0.9); launches in "
          "fit %s, in score %s"
          % (mlp._context[0], CS_EPOCHS, CS_STEPS, mlp_s, acc, fit_launches,
             score_launches))

    # LeNet: its first steps from the same weights, card vs CPU
    data = lenet_data()
    tr_x, tr_y, va_x, va_y = data
    le_p0 = lenet_init_params(mt, seed)
    rows = FIT_STEPS * LENET_BATCH
    few = (tr_x[:rows], tr_y[:rows], va_x, va_y)
    got = {ctx: module_params(lenet_fit(mt, few, ctx, le_p0, 1,
                                        shuffle=False, validate=False)[0])
           for ctx in (gpu, mt.cpu())}
    names = sorted(le_p0)
    check_close("LeNet Module.fit after %d steps, card vs CPU" % FIT_STEPS,
                [torch.from_numpy(got[gpu][k]) for k in names],
                [torch.from_numpy(got[mt.cpu()][k]) for k in names], FIT_TOL)
    print("Module.fit LeNet: %d steps on the card vs the CPU's Module: max "
          "|diff| %.3g (tolerance %s)"
          % (FIT_STEPS, max(np.abs(got[gpu][k] - got[mt.cpu()][k]).max()
                            for k in names), FIT_TOL))

    # the example itself on the current context: 3 epochs, then the final
    # score; its checkpoint loads into a CPU Module that scores the same
    np.random.seed(seed)
    t0 = time.perf_counter()
    lenet, le_train, val = lenet_fit(mt, data)
    torch.cuda.synchronize()
    lenet_s = time.perf_counter() - t0
    val_acc = dict(lenet.score(val, mt.metric.Accuracy()))["accuracy"]
    if lenet._context != [gpu]:
        fail("LeNet's Module context is %s, not gpu(0)" % lenet._context)
    if not val_acc >= LENET_MIN_ACC:
        fail("LeNet trained by Module.fit scores validation accuracy %.4f "
             "(limit %.2f)" % (val_acc, LENET_MIN_ACC))
    prefix = os.path.join(workdir, "lenet")
    lenet.save_checkpoint(prefix, LENET_EPOCHS)
    on_cpu = mt.mod.Module.load(prefix, LENET_EPOCHS, context=mt.cpu())
    on_cpu.bind(val.provide_data, val.provide_label, for_training=False)
    cpu_acc = dict(on_cpu.score(val, mt.metric.Accuracy()))["accuracy"]
    out_card = lenet.predict(val).asnumpy()
    out_cpu = on_cpu.predict(val).asnumpy()
    if cpu_acc != val_acc or not np.allclose(out_card, out_cpu,
                                             **SERVE_TOL):
        fail("LeNet's checkpoint on the CPU scores %.4f (card %.4f), "
             "outputs differ by %g" % (cpu_acc, val_acc,
                                       np.abs(out_card - out_cpu).max()))
    print("Module.fit LeNet (train_mnist.py --network lenet's call, context "
          "%s, local kvstore): %d epochs of %d steps in %.3f s; validation "
          "accuracy %.4f (limit %.2f); its checkpoint on the CPU scores "
          "%.4f, max |card - cpu| over %d outputs %.3g"
          % (lenet._context[0], LENET_EPOCHS, -(-LENET_SAMPLES //
                                                LENET_BATCH), lenet_s,
             val_acc, LENET_MIN_ACC, cpu_acc, out_cpu.shape[0],
             np.abs(out_card - out_cpu).max()))

    return {"MLP": (mlp, train)}


# ---------------------------------------------------------------------------
# the captured Module.fit: the same two fit calls with the fused train step
# (mxtpu_torch/module/fused.py), which on the card runs each batch signature's
# first step for real, captures it in a CUDA graph and replays the graph on
# every later batch; LeNet with fit's own kvstore="local" (on one device no
# store, so the fused step engages, as in mxtpu)
# ---------------------------------------------------------------------------

# Captured vs eager first steps on the card: the same kernels on the same
# inputs; only lr and the step count become float32 / int32 device scalars
# (lr * grad stays the same float32 product).
CAPTURE_TOL = dict(atol=1e-6, rtol=0)
# A whole fit, captured vs eager: the band tests/test_module_fused.py holds
# mxtpu's fused fit to its eager one in (rounding grows over the steps).
FUSED_FIT_TOL = dict(atol=1e-5, rtol=5e-4)
# Signatures in a fit with a metric, as mxtpu counts its compiles: the
# bare step (the metric registers after the first batch), then the step
# with the metric (tests/test_torch_module_fused.py holds the port's counts
# to mxtpu's on the CPU). Each runs its first step for real; the second
# signature's second step captures its graph, and every later step
# replays it: one graph a fit, the bare step's single batch never captured.
FUSED_COMPILES = 2


def with_fused(on, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with MXTPU_MODULE_FUSED set to ``on``."""
    old = os.environ.get("MXTPU_MODULE_FUSED")
    os.environ["MXTPU_MODULE_FUSED"] = "1" if on else "0"
    try:
        return fn(*args, **kwargs)
    finally:
        if old is None:
            del os.environ["MXTPU_MODULE_FUSED"]
        else:
            os.environ["MXTPU_MODULE_FUSED"] = old


def captured_steps(mod, label, steps):
    """Fail unless ``mod`` trained every one of its ``steps`` steps through
    the fused step: engaged, no fallback, FUSED_COMPILES signatures, each
    run for real at its first step, one graph (the metric's signature,
    captured at its second step) and a replay of it in every later step.
    Returns the entries that hold a graph."""
    trainer = mod._fused
    if trainer is None:
        fail("%s: the fused step is not engaged (%s)"
             % (label, getattr(mod, "_fused_fallback_logged", "disabled")))
    stats = trainer._group.stats
    want = {"steps": steps, "compiles": FUSED_COMPILES,
            "cache_hits": steps - FUSED_COMPILES, "fallbacks": 0}
    got = {k: stats[k] for k in want}
    entries = trainer._cache.entries()
    replays = sum(e.replays for e in entries)
    graphs = [e for e in entries if e.graph is not None]
    if got != want or replays != steps - FUSED_COMPILES or \
            [e.graph is not None for e in entries] != [False, True]:
        fail("%s: fused stats %s, %d replays of %d graphs in %d signatures "
             "(want %s, one graph)"
             % (label, stats, replays, len(graphs), len(entries), want))
    return graphs


def graph_nodes(mt, entries, kernels, ctx):
    """Each captured graph's nodes: (kernel nodes, other nodes, {rtc kernel
    name: its nodes}, replays)."""
    handles = {n: k.function(ctx) for n, k in kernels.items()}
    out = []
    for e in entries:
        funcs, others = mt._nvrtc.graph_kernel_functions(
            e.graph.raw_cuda_graph())
        out.append((len(funcs), others,
                    {n: funcs.count(h) for n, h in handles.items()},
                    e.replays))
    return out


def no_sync_epoch(mod, data_iter, metric):
    """One epoch of fit's loop body under torch's sync debug mode "error":
    any host wait on the card raises. Returns the steps."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fit_epoch(mod, data_iter, metric)
    except RuntimeError as e:
        fail("a steady-state epoch waited for the card: %s" % e)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def first_steps(mt, label, run, names):
    """``run(ctx, fused)`` -> {name: numpy} after FIT_STEPS steps; the
    captured steps on the card against the eager ones there (CAPTURE_TOL)
    and against the CPU's fused Module (FIT_TOL)."""
    import torch
    gpu = mt.gpu(0)
    captured = run(gpu, True)
    for what, want, tol in (("the card's eager steps", run(gpu, False),
                             CAPTURE_TOL),
                            ("the CPU's Module", run(mt.cpu(), True),
                             FIT_TOL)):
        check_close("%s: %d captured steps vs %s" % (label, FIT_STEPS, what),
                    [torch.from_numpy(captured[k]) for k in names],
                    [torch.from_numpy(want[k]) for k in names], tol)
        print("Module.fit %s: %d captured steps on the card vs %s: max "
              "|diff| %.3g (tolerance %s)"
              % (label, FIT_STEPS, what,
                 max(np.abs(captured[k] - want[k]).max() for k in names),
                 tol))


def fused_fit_phase(mt, seed, eager):
    """Both examples through Module.fit on cuda:0 with the captured step:
    its first steps against the eager ones, whole fits against the eager
    fits of the same calls, one graph a signature, B6 in each MLP step,
    no host wait in a steady-state epoch, and a custom op that reads the
    card falling back. ``eager`` gets the eager LeNet of fit's default
    kvstore. Returns the head kernels' launches in the MLP's fit and
    {label: (captured module, its iterator)}."""
    import torch
    gpu = mt.gpu(0)
    ck = cs_kernels()
    x_all, y_all = cs_data()
    cs_p0 = cs_init_params(seed)
    idx = np.concatenate(cs_batches(seed)[:FIT_STEPS])

    def mlp_first(ctx, fused):
        mod, _ = with_fused(fused, mlp_fit, mt, x_all[idx], y_all[idx], ctx,
                            cs_p0, 1, shuffle=False)
        if fused and ctx == gpu:
            captured_steps(mod, "MLP, first steps", FIT_STEPS)
        return module_params(mod)
    first_steps(mt, "MLP", mlp_first, sorted(cs_p0))

    # the example's fit, captured: every head launch ran once a step, the
    # two signatures' first steps by hand and the rest as the graph's nodes
    for kern in ck.values():
        kern.launches = 0
    mlp, train = mlp_fit(mt, x_all, y_all)
    torch.cuda.synchronize()
    entries = captured_steps(mlp, "MLP", CS_STEPS)
    cache = mlp._fused._cache.stats()
    nodes = graph_nodes(mt, entries, ck, gpu)
    launches = {n: k.launches + sum(g[2][n] * g[3] for g in nodes)
                for n, k in ck.items()}
    for kernel_nodes, others, heads, replays in nodes:
        if heads != {n: 1 for n in ck}:
            fail("a captured MLP step holds head kernel nodes %s, want one "
                 "of each" % heads)
    if launches != {n: CS_STEPS for n in ck}:
        fail("head kernels ran %s times in %d captured steps"
             % (launches, CS_STEPS))
    acc = dict(mlp.score(train, "acc"))["accuracy"]
    if not acc > 0.9:
        fail("the captured MLP scores train accuracy %.4f (limit 0.9)" % acc)
    eager_mlp = module_params(eager["MLP"][0])
    got = module_params(mlp)
    names = sorted(got)
    check_close("MLP: captured fit vs the eager fit on the card",
                [torch.from_numpy(got[k]) for k in names],
                [torch.from_numpy(eager_mlp[k]) for k in names],
                FUSED_FIT_TOL)
    metric = mt.metric.create("acc")
    fit_epoch(mlp, train, metric)
    no_sync_epoch(mlp, train, metric)
    print("Module.fit MLP captured (custom_softmax.py's call): %d epochs, "
          "%d steps: %s; graphs (kernel nodes, other nodes, head nodes, "
          "replays): %s; head launches %s; train accuracy %.4f (limit 0.9); "
          "max |captured - eager| after the fit %.3g (tolerance %s); no host "
          "wait in a steady-state epoch"
          % (CS_EPOCHS, CS_STEPS, cache, nodes, launches,
             acc, max(np.abs(got[k] - eager_mlp[k]).max() for k in names),
             FUSED_FIT_TOL))

    # LeNet with fit's default kvstore="local"
    data = lenet_data()
    tr_x, tr_y, va_x, va_y = data
    le_p0 = lenet_init_params(mt, seed)
    rows = FIT_STEPS * LENET_BATCH
    few = (tr_x[:rows], tr_y[:rows], va_x, va_y)

    def lenet_first(ctx, fused):
        mod = with_fused(fused, lenet_fit, mt, few, ctx, le_p0, 1,
                         shuffle=False, validate=False, kvstore="local")[0]
        if fused and ctx == gpu:
            captured_steps(mod, "LeNet, first steps", FIT_STEPS)
        return module_params(mod)
    first_steps(mt, "LeNet", lenet_first, sorted(le_p0))

    def lenet_whole(fused, deterministic=False):
        # the same shuffle and Xavier draws for every fit
        np.random.seed(seed)
        mt.random.seed(seed)
        old = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = deterministic
        try:
            return with_fused(fused, lenet_fit, mt, data, kvstore="local")
        finally:
            torch.backends.cudnn.deterministic = old
    # whole fits are compared under cuDNN's deterministic algorithms: by
    # its default heuristics a capture may run another convolution
    # algorithm than the eager step does, and 94 steps carry the rounding
    # apart past FUSED_FIT_TOL in a conv weight; the first steps above
    # compare the default algorithms
    same = [module_params(lenet_whole(fused, True)[0])
            for fused in (False, True)]
    eager["LeNet"] = lenet_whole(False)[:2]
    lenet, le_train, val = lenet_whole(True)
    steps = LENET_EPOCHS * -(-LENET_SAMPLES // LENET_BATCH)
    entries = captured_steps(lenet, "LeNet", steps)
    cache = lenet._fused._cache.stats()
    le_nodes = graph_nodes(mt, entries, {}, gpu)
    val_acc = dict(lenet.score(val, mt.metric.Accuracy()))["accuracy"]
    if not val_acc >= LENET_MIN_ACC:
        fail("captured LeNet scores validation accuracy %.4f (limit %.2f)"
             % (val_acc, LENET_MIN_ACC))
    want, got = same
    names = sorted(got)
    check_close("LeNet: captured fit vs the eager fit on the card "
                "(deterministic cuDNN)",
                [torch.from_numpy(got[k]) for k in names],
                [torch.from_numpy(want[k]) for k in names], FUSED_FIT_TOL)
    metric = mt.metric.create("acc")
    fit_epoch(lenet, le_train, metric)
    no_sync_epoch(lenet, le_train, metric)
    print("Module.fit LeNet captured (train_mnist.py --network lenet's call, "
          "kvstore='local'): %d epochs, %d steps: %s; graphs (kernel nodes, "
          "other nodes, -, replays): %s; validation accuracy %.4f (limit "
          "%.2f); max |captured - eager| after the fit, deterministic cuDNN, "
          "%.3g (tolerance %s); no host wait in a steady-state epoch"
          % (LENET_EPOCHS, steps, cache, le_nodes,
             val_acc, LENET_MIN_ACC,
             max(np.abs(got[k] - want[k]).max() for k in names),
             FUSED_FIT_TOL))
    for op_type in HOST_READS:
        host_read_fallback(mt, x_all[idx], y_all[idx], cs_p0, op_type)
    rnn_dropout_fit(mt, seed)
    return launches, {"MLP": (mlp, train), "LeNet": (lenet, le_train)}


def host_read_fallback(mt, x, y, params0, op_type):
    """A custom op whose Python body reads the card cannot be captured: the
    trainer falls back to the eager step, warning once and counting the
    fallback, and trains as the eager path does; after a capture that
    CUDA failed, the card's default generator draws again. An error of
    the op's own raised inside the capture is raised out of fit."""
    import warnings
    import torch
    gpu = mt.gpu(0)
    host_read_register(mt, op_type)

    def run(fused):
        np.random.seed(0)
        it = mt.io.NDArrayIter(x, y, CS_BATCH)
        mod = mt.mod.Module(cs_symbol(mt, op_type), context=gpu)
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(arg_params=host_params(mt, params0))
        with_fused(fused, mod.init_optimizer, optimizer="sgd",
                   optimizer_params={"learning_rate": CS_LR,
                                     "momentum": CS_MOMENTUM})
        trainer = mod._fused
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fit_epoch(mod, it, mt.metric.create("acc"))
        torch.cuda.synchronize()
        return mod, trainer, [str(w.message) for w in caught]

    if HOST_READS[op_type] == "fault":
        try:
            run(True)
        except ValueError as e:
            print("Module.fit with a custom op failing inside the capture "
                  "raised it: %s" % e)
            return
        fail("%s: an op's own error inside the capture did not raise"
             % op_type)
    mod, trainer, said = run(True)
    eager, _, _ = run(False)
    disabled = [m for m in said if "fused train step disabled" in m]
    if trainer is None or mod._fused is not None or len(disabled) != 1 or \
            op_type not in disabled[0] or \
            trainer._group.stats["fallbacks"] != 1:
        fail("the host-reading custom op %s did not fall back once: "
             "trainer %s, warnings %s"
             % (op_type, trainer and trainer._group.stats, said))
    got, want = module_params(mod), module_params(eager)
    names = sorted(got)
    check_close("host-reading custom op %s: fallen-back fit vs the eager "
                "fit" % op_type,
                [torch.from_numpy(got[k]) for k in names],
                [torch.from_numpy(want[k]) for k in names], CAPTURE_TOL)
    draws = [torch.rand(4, device="cuda:0") for _ in range(2)]
    if torch.equal(*draws):
        fail("after %s's fallback the card's default generator repeats"
             % op_type)
    print("Module.fit with a host-reading custom op (%s, %s) on the card: "
          "the capture was refused and the trainer fell back once (%s); "
          "stats %s; %d steps within %.3g of the eager fit; the default "
          "generator draws afterwards"
          % (op_type, HOST_READS[op_type], disabled[0],
             trainer._group.stats, FIT_STEPS,
             max(np.abs(got[k] - want[k]).max() for k in names)))


# A 2-layer LSTM with dropout between the layers, trained by Module.fit on
# the card: the RNN op draws its masks from the fused step's generator,
# which each graph registers (the op's shapes are those of
# example/rnn-time-major/rnn_cell_demo.py's copy task, a second layer
# added).
RNN_T, RNN_N, RNN_V, RNN_H, RNN_DROPOUT, RNN_EPOCHS = 12, 32, 20, 32, 0.5, 3


def rnn_dropout_symbol(mt):
    data = mt.sym.var("data")                       # (N, T) tokens
    emb = mt.sym.Embedding(mt.sym.swapaxes(data, dim1=0, dim2=1),
                           input_dim=RNN_V, output_dim=RNN_H)
    params = mt.sym.var("lstm_parameters", init=mt.init.Uniform(0.1))
    state, cell = [mt.sym.var(name, shape=(2, RNN_N, RNN_H),
                              init=mt.init.Zero())
                   for name in ("lstm_state", "lstm_state_cell")]
    out = mt.sym.RNN(emb, parameters=params, state=state, state_cell=cell,
                     state_size=RNN_H, num_layers=2, mode="lstm",
                     p=RNN_DROPOUT, name="lstm")    # (T, N, H)
    logits = mt.sym.FullyConnected(mt.sym.reshape(out, shape=(-3, 0)),
                                   num_hidden=RNN_V)
    label = mt.sym.reshape(mt.sym.swapaxes(mt.sym.var("softmax_label"),
                                           dim1=0, dim2=1), shape=(-1,))
    return mt.sym.SoftmaxOutput(logits, label, name="softmax")


def rnn_dropout_fit(mt, seed):
    """Fail unless the LSTM with dropout trains (the example's Adam)
    through one captured graph with no fallback, and each replay draws new
    masks: with lr 0, two
    replays on one batch differ, and a replay from the first one's
    generator offset gives its outputs again."""
    import torch
    rng = np.random.RandomState(seed)
    seqs = np.floor(rng.rand(RNN_N * 8, RNN_T) * (RNN_V - 1)) + 1
    labels = np.zeros_like(seqs)
    labels[:, 2:] = seqs[:, :-2]                    # the copy task, delay 2
    np.random.seed(seed)
    mt.random.seed(seed)
    it = mt.io.NDArrayIter(seqs.astype(np.float32),
                           labels.astype(np.float32), RNN_N, shuffle=True)
    mod = mt.mod.Module(rnn_dropout_symbol(mt), context=mt.gpu(0))
    mod.fit(it, optimizer="adam", optimizer_params={"learning_rate": 0.015},
            initializer=mt.init.Xavier(), num_epoch=RNN_EPOCHS,
            eval_metric="acc")
    torch.cuda.synchronize()
    steps = RNN_EPOCHS * 8
    graphs = captured_steps(mod, "LSTM with dropout", steps)
    params = module_params(mod)
    if not all(np.isfinite(v).all() for v in params.values()):
        fail("LSTM with dropout: the captured fit left non-finite weights")
    mod._optimizer.lr = 0.0
    gen = mod._fused._group.generator
    batch = next(iter(it))
    outs, offsets = [], []
    for _ in range(3):
        if len(outs) == 2:
            gen.set_offset(offsets[0])
        offsets.append(gen.get_offset())
        mod.forward_backward(batch)
        mod.update()
        outs.append(mod.get_outputs()[0].asnumpy().copy())
    if graphs[0].replays != steps - FUSED_COMPILES + 3:
        fail("LSTM with dropout: the lr-0 steps did not replay the graph")
    if np.array_equal(outs[0], outs[1]) or \
            not np.array_equal(outs[0], outs[2]):
        fail("LSTM with dropout: replays do not draw new masks from the "
             "step's generator (offsets %s)" % offsets)
    after = module_params(mod)
    if any(not np.array_equal(after[k], params[k]) for k in params):
        fail("LSTM with dropout: a step at lr 0 moved the weights")
    print("Module.fit LSTM with dropout %.1f between 2 layers (T=%d, N=%d, "
          "H=%d) captured: %d steps, %s; replays draw new masks (offsets "
          "%s), a replay from the first offset repeats it"
          % (RNN_DROPOUT, RNN_T, RNN_N, RNN_H, steps,
             mod._fused._cache.stats(), offsets))


# ---------------------------------------------------------------------------
# the bucketed LSTM LM of example/rnn/lstm_bucketing.py (BASELINE.json config
# 4) trained through BucketingModule.fit: one Module a bucket over one set of
# parameter tensors; on the card, one CUDA graph a bucket, lstm_scan inside
# each in the fused-cell model
# ---------------------------------------------------------------------------

# the example's published widths and recipe
BL_EMBED, BL_HIDDEN, BL_LAYERS, BL_BATCH = 200, 200, 2, 32
BL_BUCKETS, BL_LR, BL_EPOCHS = (8, 16, 24, 32), 0.01, 5
# PTB's vocabulary (as the serving slice) for the timed run, over the
# example's synthetic sentences
BL_PTB_SENTENCES = 2000
BL_GRU_EPOCHS = 1
# the example's fit must end below this share of its first epoch's
# perplexity (tests/test_rnn.py holds mxtpu's LM to it)
BL_PPL_DROP = 0.9


def synthetic_corpus(n=500, vocab=64, seed=0):
    """example/rnn/lstm_bucketing.py's synthetic corpus (a copy: the
    example imports mxtpu): n sentences of 8, 16, 24 or 32 tokens, each
    counting up from a random start, ids in [1, vocab)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ln = int(rng.choice([8, 16, 24, 32]))
        start = rng.randint(1, vocab)
        out.append([(start + i) % (vocab - 1) + 1 for i in range(ln)])
    return out, vocab


def bucket_sentences(sentences, buckets, bucket, n):
    """The first ``n`` sentences that fall in ``bucket``."""
    low = max([b for b in buckets if b < bucket], default=0)
    return [s for s in sentences if low < len(s) <= bucket][:n]


def lstm_rnn_cell(pkg, fused, mode="lstm", num_hidden=BL_HIDDEN,
                  num_layers=BL_LAYERS):
    """The example's recurrent stack: a FusedRNNCell of ``mode`` when
    ``fused``, else a SequentialRNNCell of LSTMCells
    (example/rnn/lstm_bucketing.py:80-89)."""
    if fused:
        return pkg.rnn.FusedRNNCell(num_hidden, num_layers=num_layers,
                                    mode=mode, prefix="lstm_")
    stack = pkg.rnn.SequentialRNNCell()
    for i in range(num_layers):
        stack.add(pkg.rnn.LSTMCell(num_hidden, prefix="lstm_l%d_" % i))
    return stack


def lstm_sym_gen(pkg, num_vocab, fused, mode="lstm", num_hidden=BL_HIDDEN,
                 num_embed=BL_EMBED, num_layers=BL_LAYERS):
    """The example's sym_gen: Embedding, the stack unrolled over the
    bucket, FullyConnected to the vocabulary, SoftmaxOutput."""
    def sym_gen(seq_len):
        data = pkg.sym.var("data")
        label = pkg.sym.var("softmax_label")
        embed = pkg.sym.Embedding(data, input_dim=num_vocab,
                                  output_dim=num_embed, name="embed")
        stack = lstm_rnn_cell(pkg, fused, mode, num_hidden, num_layers)
        outputs, _ = stack.unroll(seq_len, inputs=embed, layout="NTC",
                                  merge_outputs=True)
        pred = pkg.sym.Reshape(outputs, shape=(-1, num_hidden))
        pred = pkg.sym.FullyConnected(pred, num_hidden=num_vocab,
                                      name="pred")
        label_r = pkg.sym.Reshape(label, shape=(-1,))
        return (pkg.sym.SoftmaxOutput(pred, label_r, name="softmax"),
                ("data",), ("softmax_label",))
    return sym_gen


def lstm_bucketing_fit(pkg, sentences, num_vocab, fused, mode="lstm",
                       num_epoch=BL_EPOCHS, num_hidden=BL_HIDDEN,
                       num_embed=BL_EMBED, num_layers=BL_LAYERS,
                       batch_size=BL_BATCH, buckets=BL_BUCKETS, lr=BL_LR,
                       arg_params=None, seed=0, optimizer="adam"):
    """example/rnn/lstm_bucketing.py's main in either package (``pkg`` for
    ``mx``), line for line: BucketSentenceIter, sym_gen (FusedRNNCell of
    ``mode`` when ``fused``, else a SequentialRNNCell of LSTMCells), a
    BucketingModule on the current context, and its fit call (Adam at
    ``lr``, Xavier, Perplexity(ignore_label=0), Speedometer); optionally
    from given weights ({name: numpy}) or with another ``optimizer``. Python's and numpy's generators
    are seeded first, so both packages draw one batch order. Returns
    (module, iterator, the perplexity fit reports after each epoch)."""
    random.seed(seed)
    np.random.seed(seed)
    pkg.random.seed(seed)
    train = pkg.rnn.BucketSentenceIter(sentences, batch_size,
                                       buckets=list(buckets),
                                       invalid_label=0)
    sym_gen = lstm_sym_gen(pkg, num_vocab, fused, mode, num_hidden,
                           num_embed, num_layers)
    mod = pkg.mod.BucketingModule(sym_gen,
                                  default_bucket_key=train.default_bucket_key,
                                  context=pkg.context.current_context())
    perplexity = {}

    def record(param):
        # before Speedometer, which may reset the metric
        perplexity[param.epoch] = param.eval_metric.get()[1]
    mod.fit(train,
            eval_metric=pkg.metric.Perplexity(ignore_label=0),
            optimizer=optimizer,
            optimizer_params={"learning_rate": lr},
            initializer=pkg.init.Xavier(),
            num_epoch=num_epoch,
            batch_end_callback=[record,
                                pkg.callback.Speedometer(batch_size, 20)],
            arg_params=host_params(pkg, arg_params))
    return mod, train, [perplexity[e] for e in sorted(perplexity)]


# The first steps of the bucketed LM, captured on the card, against the
# same fused step uncaptured there, the CPU's fused Module and (SGD) the
# card's eager step. With SGD every weight within CAPTURE_TOL / FIT_TOL (no
# division: the port and mxtpu end 3 steps at the example's widths within
# 7.8e-8 on the CPU). Adam, the example's optimizer, divides each step by
# sqrt(v) + 1e-8: where a gradient nearly cancels, a last-bit difference in
# it (another summation order; the embedding's gradient sums its rows by
# atomics on the card) moves the weight by up to lr (1 - beta1) / 1e-8 =
# 1e5 times that difference, from the first step on
# (tests/test_torch_bucketing.py). Adam's steps are held to the tolerances
# in all but a few weights, each within a limit, set for each comparison at
# three times its largest readings on the H100 (FusedRNNCell; the
# LSTMCells' are lower): against the uncaptured step 2-5 weights past
# CAPTURE_TOL, at most 2.3e-6 (the atomics: it varies run to run); against
# the CPU 19 past FIT_TOL, at most 4.22e-5.
BL_FIRST_LR = {"sgd": 0.1, "adam": BL_LR}
BL_ADAM_APART = {"uncaptured": dict(beyond=15, limit=7e-6),
                 "cpu": dict(beyond=60, limit=1.3e-4)}
# a model that has learnt nothing scores the vocabulary size; one epoch of
# the GRU variant must get below half of it (the port reaches 12.9 of 64 on
# the CPU)
BL_GRU_PPL_SHARE = 0.5
# replays of bucket 32's graph traced for the split of its step
BL_SPLIT_REPLAYS = 5


def mostly_close(got, want, names, tol, beyond, limit):
    """(weights past ``tol``, largest difference); fails past ``beyond``
    weights or ``limit``."""
    past, worst = 0, 0.0
    for k in names:
        d = np.abs(got[k] - want[k])
        past += int((d > tol["atol"] + tol["rtol"] * np.abs(want[k])).sum())
        worst = max(worst, float(d.max()))
    return past, worst, past <= beyond and worst <= limit


def bucket_graph_report(mt, mod, labels=None):
    """Each bucket's captured step: {bucket: (kernel nodes, other nodes,
    {"lstm"/"gru": time-loop kernel nodes}, replays, pool bytes)};
    fails unless each bucket holds one program, captured, replayed at
    every hit. ``labels``, where given, gets {bucket: {rnn_kernel_label:
    nodes}}."""
    names = {}
    out = {}
    for key, sub in sorted(mod._buckets.items()):
        trainer = sub._fused
        if trainer is None:
            fail("bucket %s: the fused step is not engaged (%s)"
                 % (key, getattr(sub, "_fused_fallback_logged",
                                 "disabled")))
        entries = trainer._cache.entries()
        stats = trainer._cache.stats()
        if len(entries) != 1 or entries[0].graph is None or \
                stats["compiles"] != 1 or \
                entries[0].replays != stats["hits"]:
            fail("bucket %s: %d programs %s, graph %s, %d replays (want one "
                 "program, captured, a replay a hit)"
                 % (key, len(entries), stats,
                    entries and entries[0].graph is not None,
                    entries[0].replays if entries else 0))
        entry = entries[0]
        funcs, others = mt._nvrtc.graph_kernel_functions(
            entry.graph.raw_cuda_graph())
        scans = {"lstm": 0, "gru": 0}
        for f in funcs:
            if f not in names:
                names[f] = mt._nvrtc.function_name(f)
            label = rnn_kernel_label(names[f])
            if label:
                scans[label.split()[0]] += 1
                if labels is not None:
                    found = labels.setdefault(key, {})
                    found[label] = found.get(label, 0) + 1
        out[key] = (len(funcs), others, scans, entry.replays,
                    entry.pool_bytes)
    return out


def check_one_store(mod, label):
    """Fail unless every bucket's executors work on the fused group's
    parameter and aux tensors."""
    groups = {id(sub._fused._group) for sub in mod._buckets.values()}
    fs = next(iter(mod._buckets.values()))._fused._group
    if len(groups) != 1:
        fail("%s: the buckets run %d fused groups, want one" % (label,
                                                               len(groups)))
    for key, sub in mod._buckets.items():
        exec_ = sub._exec_group.execs[0]
        for name, arr in list(fs.param_store.items()) + \
                list(fs.aux_store.items()):
            mine = exec_.arg_dict.get(name, exec_.aux_dict.get(name))
            if mine is not arr or mine.data.data_ptr() != \
                    arr.data.data_ptr():
                fail("%s: bucket %s's %s is not the group's tensor"
                     % (label, key, name))


def bucketed_fit(mt, rnn_scan, sentences, vocab, fused, mode="lstm",
                 num_epoch=BL_EPOCHS):
    """The example's fit on the current context, gpu(0), captured (the
    fused step, the default), with the time-loop launch counts set to 0
    just before it: (module, iterator, perplexities, steps, graph report,
    {kernel: launches}, seconds). Launches: the warm-up steps' own, plus
    each graph's nodes times its replays."""
    import torch
    rnn_scan.reset_launches()
    t0 = time.perf_counter()
    mod, it, ppl = lstm_bucketing_fit(mt, sentences, vocab, fused,
                                      mode=mode, num_epoch=num_epoch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = dict(rnn_scan.LAUNCHES)
    steps = num_epoch * len(it.idx)
    label = "bucketed LM (%s, %s)" % (mode, "FusedRNNCell" if fused
                                      else "LSTMCells")
    if mod._curr_module._context != [mt.gpu(0)]:
        fail("%s: context %s, not gpu(0)" % (label,
                                             mod._curr_module._context))
    report = bucket_graph_report(mt, mod)
    fs = mod._curr_module._fused._group
    compiles = sum(sub._fused._cache.stats()["compiles"]
                   for sub in mod._buckets.values())
    want = {"steps": steps, "compiles": len(BL_BUCKETS),
            "cache_hits": steps - len(BL_BUCKETS), "fallbacks": 0}
    got = {k: fs.stats[k] for k in want}
    if got != want or compiles != len(BL_BUCKETS) or \
            sorted(report) != sorted(BL_BUCKETS):
        fail("%s: fused stats %s over buckets %s (want %s)"
             % (label, fs.stats, sorted(report), want))
    check_one_store(mod, label)
    launches = {}
    for kind in ("lstm", "gru"):
        name = kind + "_scan"
        nodes = {k: r[2][kind] for k, r in report.items()}
        launches[name] = launched[name] + sum(
            r[2][kind] * r[3] for r in report.values())
        want_nodes = BL_LAYERS if fused and mode == kind else 0
        if any(n != want_nodes for n in nodes.values()) or \
                launches[name] != want_nodes * steps:
            fail("%s: %s nodes a bucket graph %s, %d launches in %d steps "
                 "(want %d a graph, one a layer a step)"
                 % (label, name, nodes, launches[name], steps, want_nodes))
    return mod, it, ppl, steps, report, launches, seconds


def bucketed_first_steps(mt, sentences, vocab, optimizer):
    """FIT_STEPS steps of the example's fit (FusedRNNCell) in bucket 32
    from the same weights, captured on the card, against the same fused step run
    uncaptured on the card (CAPTURE_TOL), the CPU's fused Module (FIT_TOL)
    and, with SGD, the card's eager step (CAPTURE_TOL); with Adam all but
    BL_ADAM_APART's weights, each comparison its own. (Adam's eager step
    folds its rate on the host in float64 where the fused step computes
    it on the card in float32; mxtpu's two steps end 3 Adam steps of this
    model 55,764 of 668,864 weights past 1e-6 apart, at most 1.34e-4, on
    the CPU, and the port's alike, so Adam's eager step is not the fused
    step's reference.)"""
    from mxtpu_torch.module import fused as fused_mod
    gpu = mt.gpu(0)
    few = bucket_sentences(sentences, BL_BUCKETS, BL_BUCKETS[-1],
                           FIT_STEPS * BL_BATCH)
    with mt.cpu():
        mod0, _, _ = lstm_bucketing_fit(mt, sentences, vocab, True,
                                        num_epoch=0)
    p0 = module_params(mod0)
    names = sorted(p0)
    lr = BL_FIRST_LR[optimizer]

    def run(ctx, fused_step, capture=True):
        on_card = fused_mod.FusedModuleTrainer._on_card
        if not capture:
            fused_mod.FusedModuleTrainer._on_card = lambda self: False
        try:
            with ctx:
                mod = with_fused(fused_step, lstm_bucketing_fit, mt, few,
                                 vocab, True, num_epoch=1,
                                 buckets=BL_BUCKETS[-1:], arg_params=p0,
                                 optimizer=optimizer, lr=lr)[0]
        finally:
            fused_mod.FusedModuleTrainer._on_card = on_card
        if fused_step and capture and ctx == gpu:
            report = bucket_graph_report(mt, mod)
            if [r[3] for r in report.values()] != [FIT_STEPS - 1]:
                fail("bucketed LM first steps: %s (want one graph, %d "
                     "replays)" % (report, FIT_STEPS - 1))
        return module_params(mod)
    captured = run(gpu, True)
    label = "bucketed LM (FusedRNNCell) %d steps, %s" % (FIT_STEPS,
                                                         optimizer)
    against = [("the fused step uncaptured on the card",
                run(gpu, True, capture=False), CAPTURE_TOL, "uncaptured"),
               ("the CPU's fused Module", run(mt.cpu(), True), FIT_TOL,
                "cpu")]
    if optimizer == "sgd":
        against.append(("the card's eager steps", run(gpu, False),
                        CAPTURE_TOL, None))
    readings = []
    for what, want, tol, apart in against:
        allowed = BL_ADAM_APART[apart] if optimizer == "adam" else \
            dict(beyond=0, limit=float("inf"))
        past, worst, ok = mostly_close(captured, want, names, tol,
                                       **allowed)
        if not ok:
            fail("%s: captured vs %s: %d of %d weights past %s, largest "
                 "difference %.3g (allowed %s)"
                 % (label, what, past, sum(v.size for v in want.values()),
                    tol, worst, allowed))
        readings.append("vs %s: %d weights past %s, max |diff| %.3g"
                        % (what, past, tol, worst))
    print("Module.fit %s on the card, captured: %s" % (label,
                                                      "; ".join(readings)))


@contextlib.contextmanager
def capture_marks(mt, rnn_scan):
    """While the fused trainer captures a step, the nodes (kernels, copies
    and sets) its graph holds at the step's phase boundaries, read from
    the graph under capture (``_nvrtc.capturing_graph``): "backward" as
    the step enters
    torch.autograd.grad, "update" as it leaves it, "recompute" and
    "recompute end" around each call of the time loops' recompute
    backward (``rnn_scan._recompute_vjp``). Host reads only: the graph
    holds the nodes it holds without them. Yields {id(entry): [(mark,
    nodes so far)]}."""
    import torch
    from mxtpu_torch.module import fused as fused_mod
    marks, current, active = {}, {}, set()
    capture = fused_mod.FusedModuleTrainer._capture
    grad, recompute = torch.autograd.grad, rnn_scan._recompute_vjp

    def mark(name):
        entry = current.get("entry")
        if entry is None or not torch.cuda.is_current_stream_capturing():
            return
        funcs, others = mt._nvrtc.graph_kernel_functions(
            mt._nvrtc.capturing_graph(torch.cuda.current_stream().cuda_stream))
        marks.setdefault(id(entry), []).append((name, len(funcs) + others))

    def marked_capture(self, entry):
        current["entry"] = entry
        try:
            return capture(self, entry)
        finally:
            del current["entry"]

    def marked(fn, before, after):
        # the recompute takes its own torch.autograd.grad inside the
        # step's: only the outermost call of each marks
        def call(*args, **kwargs):
            if before in active:
                return fn(*args, **kwargs)
            active.add(before)
            try:
                mark(before)
                out = fn(*args, **kwargs)
                mark(after)
            finally:
                active.discard(before)
            return out
        return call
    fused_mod.FusedModuleTrainer._capture = marked_capture
    torch.autograd.grad = marked(grad, "backward", "update")
    rnn_scan._recompute_vjp = marked(recompute, "recompute", "recompute end")
    try:
        yield marks
    finally:
        fused_mod.FusedModuleTrainer._capture = capture
        torch.autograd.grad = grad
        rnn_scan._recompute_vjp = recompute


def traced_replays(graph, n, replays):
    """torch.profiler over ``replays`` back-to-back replays of ``graph``
    (``n`` nodes; three replays run first): the device events of each
    replay that the trace holds whole, in the order they ran, counted
    back from the last (a node is one event: a kernel, a copy node as
    the copy kernel it runs, a set; a replay is whole where it runs the
    last one's events in its order), and each such replay's card busy
    ms. Fails unless two replays are whole."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(replays):
            graph.replay()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    reps = [events[len(events) - i * n:len(events) - (i - 1) * n]
            for i in range(len(events) // n, 0, -1)]
    order = [e.name for e in reps[-1]] if reps else []
    reps = [es for es in reps if [e.name for e in es] == order]
    if len(reps) < 2:
        fail("%d device events traced in %d replays of a graph of %d "
             "nodes, %d replays whole" % (len(events), replays, n,
                                          len(reps)))
    return reps, [sum(e.time_range.elapsed_us() for e in es) / 1e3
                  for es in reps]


def own_graph_split(mt, mod, marks, bucket, own_ms, reps):
    """Where the trainer's own captured step at ``bucket`` (FusedRNNCell)
    spends the card's time, from ``reps`` (``traced_replays`` of its
    graph): captured on one stream, the graph is a chain that runs its
    nodes in capture order, so the i-th event of a replay is the i-th
    node the capture recorded, and ``capture_marks``' marks (nodes
    recorded so far) give it its part: the forward to B4's last kernel
    (embedding, projections, B4), the head's forward, the head's backward
    (to the first recompute), the recompute backward, the rest of the
    backward (the projections' and the embedding's gradients) and the
    update. A part's card time is the time its nodes ran; medians over
    the replays. (Not the gaps between nodes: tracing widens them, in a
    process that has traced before by several times.) Fails unless the
    marks are in order, every replay runs the same kernels in the same
    order with B4's two in the forward, every part's card time is
    positive and their sum, the step's card time, is no more than
    ``own_ms`` (the graph's replay timed by events, without the
    profiler) and the 15% that tracing may add to it. Returns ({part:
    card ms}, B4's card ms, B4's places)."""
    entry = mod._buckets[bucket]._fused._cache.entries()[0]
    funcs, others = mt._nvrtc.graph_kernel_functions(
        entry.graph.raw_cuda_graph())
    n = len(funcs) + others
    got = marks.get(id(entry), [])
    want = ["backward"] + ["recompute", "recompute end"] * BL_LAYERS + \
        ["update"]
    at = [k for _m, k in got]
    order = [k.name for k in reps[-1]]
    b4 = [i for i, name in enumerate(order) if "rnn_cluster_kernel" in name]
    if [m for m, _k in got] != want or at != sorted(at) or \
            not at[-1] < n or \
            any([k.name for k in ks] != order for ks in reps) or \
            len(b4) != BL_LAYERS or not b4[-1] + 1 < at[0]:
        fail("bucket %d's graph: marks %s of %d nodes; %d traced "
             "replays, %d of them in the last one's order; B4 at %s (want "
             "%s in order, the same kernels a replay, B4's %d before the "
             "backward); the last replay's first kernels: %s"
             % (bucket, got, n, len(reps),
                sum([k.name for k in ks] == order for ks in reps), b4,
                want, BL_LAYERS, [name[:40] for name in order[:40]]))
    a, r, b = at[0], at[1:-1], at[-1]
    bounds = [("forward (embedding, projections, B4)", 0, b4[-1] + 1),
              ("head forward", b4[-1] + 1, a),
              ("head backward", a, r[0])]
    for i in range(0, len(r), 2):
        bounds.append(("recompute backward", r[i], r[i + 1]))
        bounds.append(("other backward", r[i + 1],
                       r[i + 2] if i + 2 < len(r) else b))
    bounds.append(("update", b, n))
    busy = {name: [] for name, _lo, _hi in bounds}
    b4_busy = []
    for ks in reps:
        used = {name: 0.0 for name in busy}
        for name, lo, hi in bounds:
            used[name] += sum(k.time_range.elapsed_us()
                              for k in ks[lo:hi]) / 1e3
        for name in busy:
            busy[name].append(used[name])
        b4_busy.append(sum(ks[i].time_range.elapsed_us() for i in b4) / 1e3)
    parts = {k: float(np.median(v)) for k, v in busy.items()}
    if min(parts.values()) <= 0 or sum(parts.values()) > 1.15 * own_ms:
        fail("bucket %d's step split %s (card time %.3f ms) against the "
             "graph's replay %.3f ms (want every part positive, the sum at "
             "most 1.15 x the replay)" % (bucket, parts,
                                          sum(parts.values()), own_ms))
    return parts, float(np.median(b4_busy)), b4


def replay_out_of_order(mod, it, label):
    """Each bucket's graph replayed, in ascending and then descending
    bucket order (one of the two is not the order the graphs were
    captured in, and each replay follows another graph's in the shared
    pool), gives the outputs that the eager forward gives on the weights
    the step starts from (CAPTURE_TOL). Fails on a difference or a new
    capture."""
    import torch
    first = {}
    it.reset()
    for batch in it:
        first.setdefault(batch.bucket_key, batch)
    fs = mod._curr_module._fused._group
    compiles = fs.stats["compiles"]
    worst = 0.0
    for key in sorted(first) + sorted(first, reverse=True):
        batch = first[key]
        mod.forward(batch, is_train=False)
        want = mod.get_outputs()[0].asnumpy()
        replays = mod._buckets[key]._fused._cache.entries()[0].replays
        mod.forward_backward(batch)
        mod.update()
        got = mod.get_outputs()[0].asnumpy()
        torch.cuda.synchronize()
        if mod._buckets[key]._fused._cache.entries()[0].replays != \
                replays + 1 or not np.allclose(got, want, **CAPTURE_TOL):
            fail("%s: bucket %d's graph replayed out of capture order: "
                 "outputs %.3g from the eager forward's (%s)"
                 % (label, key, float(np.abs(got - want).max()),
                    CAPTURE_TOL))
        worst = max(worst, float(np.abs(got - want).max()))
    if fs.stats["compiles"] != compiles:
        fail("%s: the replays out of order compiled anew" % label)
    return worst


def bucketed_lm_phase(mt, rnn_scan, rng, dev, card):
    """The bucketed LSTM LM (BASELINE.json config 4) through
    BucketingModule.fit on cuda:0: the time loops at the buckets' lengths
    against their plain versions; the example's own run, FusedRNNCell
    (lstm_scan in every bucket's graph) and then LSTMCells, 5 epochs,
    captured, one graph a bucket over one parameter store, perplexity
    falling, each bucket's graph right when replayed out of capture
    order; its first steps against the eager ones and the CPU's; the
    timed run at PTB's vocabulary, eager and captured in turns, with the
    graphs, their pools, the card's busy share and where a step's card
    time goes (a trace of the trainer's own graph); the GRU variant (gru_scan in every graph), 1 epoch.
    Returns the launches of lstm_scan in the example's fused run and of
    gru_scan in the GRU variant, and each kernel's largest error against
    its plain version at the buckets' lengths."""
    import torch
    clock = [("start", time.perf_counter())]
    errs = {"lstm_scan": 0.0, "gru_scan": 0.0}
    # the time loops at each bucket's length, B=32, H=200
    for T in BL_BUCKETS:
        report = []
        for name, make in (("lstm_scan", lstm_args), ("gru_scan", gru_args)):
            a = make(rng, BL_BATCH, torch.float32, dev, T=T, H=BL_HIDDEN)
            got = getattr(rnn_scan, name)(*a)
            want = getattr(rnn_scan, name + "_reference")(*a)
            check_close("%s T=%d N=%d H=%d" % (name, T, BL_BATCH, BL_HIDDEN),
                        got, want, F32_TOL)
            errs[name] = max(errs[name], max_err(got, want))
            report.append("%s max err %.3g" % (name, max_err(got, want)))
        print("check bucket T=%d N=%d H=%d f32 (tolerance %s): %s"
              % (T, BL_BATCH, BL_HIDDEN, F32_TOL, "; ".join(report)))

    # Embedding on ids outside [0, rows) follows jnp.take (a negative id
    # wraps once, a row past the end is NaN) with no device-side assert:
    # the card's context keeps working after it
    w = np.arange(12, dtype=np.float32).reshape(4, 3) / 10
    ids = np.array([1, 5, -1, -6, 3, 4], np.float32)
    rows = [mt.nd.Embedding(mt.nd.array(ids, ctx=ctx), mt.nd.array(w, ctx=ctx),
                            input_dim=4, output_dim=3).asnumpy()
            for ctx in (mt.gpu(0), mt.cpu())]
    torch.cuda.synchronize()
    if not np.array_equal(rows[0], rows[1], equal_nan=True) or \
            int(np.isnan(rows[0]).any(1).sum()) != 3:
        fail("Embedding on out-of-range ids: card %s, CPU %s" % tuple(rows))
    print("check Embedding on ids %s on the card: rows equal to the CPU's, "
          "3 NaN rows, no device-side assert" % ids.astype(int).tolist())
    clock.append(("kernels", time.perf_counter()))
    # the example's own run: its corpus, 5 epochs, --fused, then the
    # unfused default, each captured
    sentences, vocab = synthetic_corpus()
    out = {}
    for fused in (True, False):
        mod, it, ppl, steps, report, launches, secs = bucketed_fit(
            mt, rnn_scan, sentences, vocab, fused)
        label = "FusedRNNCell" if fused else "LSTMCells"
        if not np.isfinite(ppl).all() or not ppl[-1] < BL_PPL_DROP * ppl[0]:
            fail("bucketed LM (%s): perplexity by epoch %s (the last must "
                 "be below %.1f x the first)" % (label, ppl, BL_PPL_DROP))
        if fused:
            out["lstm_scan"] = launches["lstm_scan"]
        print("Module.fit bucketed LM (lstm_bucketing.py%s, context gpu(0), "
              "captured): %d epochs, %d steps in %.2f s; perplexity by "
              "epoch %s (limit %.1f x the first); %s; graphs by bucket "
              "(kernel nodes, other nodes, time-loop nodes, replays, pool "
              "bytes): %s; launches %s; one parameter store"
              % (" --fused" if fused else "", BL_EPOCHS, steps, secs,
                 ", ".join("%.4f" % p for p in ppl), BL_PPL_DROP,
                 mod._curr_module._fused._group.stats, report, launches))
        worst = replay_out_of_order(mod, it, "bucketed LM (%s)" % label)
        print("check bucketed LM (%s): each bucket's graph replayed in "
              "ascending and descending bucket order, outputs against the "
              "eager forward: max |diff| %.3g (tolerance %s)"
              % (label, worst, CAPTURE_TOL))
    clock.append(("the example's fits", time.perf_counter()))
    # the fused cell's model only (B4's path): the LSTMCells' graphs are
    # held to the eager forward above
    for optimizer in ("sgd", "adam"):
        bucketed_first_steps(mt, sentences, vocab, optimizer)
    clock.append(("first steps", time.perf_counter()))

    # the timed run at PTB's vocabulary: eager and captured, in turns
    ptb, ptb_vocab = synthetic_corpus(n=BL_PTB_SENTENCES, vocab=VOCAB)
    with capture_marks(mt, rnn_scan) as marks:
        runs = {"eager": with_fused(False, lstm_bucketing_fit, mt, ptb,
                                    ptb_vocab, True, num_epoch=1),
                "captured": lstm_bucketing_fit(mt, ptb, ptb_vocab, True,
                                               num_epoch=1)}
    clock.append(("PTB-width fits (captures)", time.perf_counter()))
    if any(sub._fused is not None
           for sub in runs["eager"][0]._buckets.values()):
        fail("the eager bucketed LM took the fused step")
    report = bucket_graph_report(mt, runs["captured"][0])
    graphs = {k: id(sub._fused._cache.entries()[0].graph)
              for k, sub in runs["captured"][0]._buckets.items()}
    metrics = {k: mt.metric.Perplexity(ignore_label=0) for k in runs}
    per_bucket = {k: {} for k in runs}
    ms, tokens_s = {k: [] for k in runs}, {k: [] for k in runs}
    for k in ("eager", "captured", "captured", "eager"):
        mod, it, _ = runs[k]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = fit_epoch(mod, it, metrics[k], per_bucket=per_bucket[k])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        tokens = sum(BL_BATCH * BL_BUCKETS[i] for i, _j in it.idx)
        ms[k].append(dt / steps * 1e3)
        tokens_s[k].append(tokens / dt)
    after = {k: id(sub._fused._cache.entries()[0].graph)
             for k, sub in runs["captured"][0]._buckets.items()}
    if after != graphs or bucket_graph_report(mt, runs["captured"][0]) \
            .keys() != report.keys():
        fail("the timed epochs captured again")
    check_one_store(runs["captured"][0], "bucketed LM at PTB's vocabulary")
    clock.append(("timed epochs", time.perf_counter()))
    # the card's busy time: each bucket's graph traced, weighted by the
    # timed epochs' steps a bucket (the batch copy and the metric's pick
    # outside the graphs are not counted). The eager step launches the
    # same kernels one by one; a profiler pass over its epoch takes over
    # a minute, so its busy time is not measured here
    traces, busy = {}, {}
    for key, sub in sorted(runs["captured"][0]._buckets.items()):
        traces[key], per = traced_replays(
            sub._fused._cache.entries()[0].graph,
            report[key][0] + report[key][1], BL_SPLIT_REPLAYS)
        busy[key] = float(np.median(per))
    counts = {b: len(v) for b, v in per_bucket["captured"].items()}
    busy_step = sum(busy[b] * c for b, c in counts.items()) / \
        sum(counts.values())
    for k in ("eager", "captured"):
        mod, it, _ = runs[k]
        step = float(np.mean(ms[k]))
        print("Module.fit bucketed LM vocab %d %s step: %.3f ms (two epochs "
              "of %d steps: %s, host clock, the metric's read of the "
              "picked values waits for each step), %.0f tokens/s (batch x "
              "bucket length); ms a step by bucket: %s; %s | %s"
              % (VOCAB, k, step, len(it.idx),
                 ", ".join("%.3f" % v for v in ms[k]),
                 float(np.mean(tokens_s[k])), ", ".join(
                     "%d: %.3f" % (b, float(np.mean(v)))
                     for b, v in sorted(per_bucket[k].items())),
                 busy_of(busy_step, step) + " (the graphs' busy ms by "
                 "bucket %s, traced)" % ", ".join(
                     "%d: %.3f" % kv for kv in sorted(busy.items()))
                 if k == "captured" else "card busy not measured (the "
                 "same kernels, launched one by one)", card))
    print("Module.fit bucketed LM vocab %d step: eager %.3f ms, captured "
          "%.3f ms (%.2fx); graphs by bucket (kernel nodes, other nodes, "
          "time-loop nodes, replays, pool bytes): %s; the shared pool "
          "%.1f MB | %s"
          % (VOCAB, float(np.mean(ms["eager"])),
             float(np.mean(ms["captured"])),
             float(np.mean(ms["eager"])) / float(np.mean(ms["captured"])),
             report, sum(r[4] for r in report.values()) / 1e6, card))
    clock.append(("graph traces", time.perf_counter()))
    bucket = BL_BUCKETS[-1]
    own = runs["captured"][0]._buckets[bucket]._fused
    own_ms = cuda_ms(own._cache.entries()[0].graph.replay,
                     iters=BL_SPLIT_REPLAYS, warmup=3)
    parts, b4_ms, b4_at = own_graph_split(
        mt, runs["captured"][0], marks, bucket, own_ms, traces[bucket])
    step = sum(parts.values())
    backward = sum(v for k, v in parts.items() if "backward" in k)
    print("Module.fit bucketed LM vocab %d bucket %d captured step on the "
          "card: the trainer's graph %.3f ms (events over back-to-back "
          "replays); its trace (%d whole replays, each node's card time "
          "given to its part): step %.3f ms of card time; by part: %s; B4 "
          "forward (nodes %s of %d) %.3f ms; backward %.3f ms, %.1f%% of "
          "the step's card time; marks %s | %s"
          % (VOCAB, bucket, own_ms, len(traces[bucket]), step, "; ".join(
                 "%s %.3f ms" % kv for kv in parts.items()), b4_at,
             report[bucket][0] + report[bucket][1], b4_ms,
             backward, 100 * backward / step,
             marks[id(own._cache.entries()[0])], card))
    clock.append(("the step's split (trace)", time.perf_counter()))
    # the GRU variant: gru_scan in every bucket's graph
    mod, it, ppl, steps, report, launches, secs = bucketed_fit(
        mt, rnn_scan, sentences, vocab, True, mode="gru",
        num_epoch=BL_GRU_EPOCHS)
    if not np.isfinite(ppl).all() or \
            not ppl[-1] < BL_GRU_PPL_SHARE * vocab:
        fail("bucketed GRU LM: perplexity %s after %d epoch (limit %.1f)"
             % (ppl, BL_GRU_EPOCHS, BL_GRU_PPL_SHARE * vocab))
    out["gru_scan"] = launches["gru_scan"]
    print("Module.fit bucketed GRU LM (FusedRNNCell mode='gru', captured): "
          "%d epoch, %d steps in %.2f s; perplexity %.4f (limit %.1f); "
          "graphs by bucket: %s; launches %s"
          % (BL_GRU_EPOCHS, steps, secs, ppl[-1], BL_GRU_PPL_SHARE * vocab,
             report, launches))
    clock.append(("the GRU variant", time.perf_counter()))
    print("bucketed LM phase: %.1f s (%s)" % (
        clock[-1][1] - clock[0][1], ", ".join(
            "%s %.1f" % (name, t - clock[i][1])
            for i, (name, t) in enumerate(clock[1:]))))
    return out, errs


# ---------------------------------------------------------------------------
# the ResNet slice: example/image-classification/train_imagenet.py
# --benchmark 1 (BASELINE.json config 2) through common/fit.py's Module.fit
# call. The example's modules import mxtpu, so its symbol functions
# (symbols/resnet.py, symbols/inception_bn.py), its SyntheticDataIter
# (common/data.py) and its fit call (common/fit.py) are mirrored here, line
# for line, for either package.
# ---------------------------------------------------------------------------

def _resnet_bn(pkg, data, name):
    return pkg.sym.BatchNorm(data, fix_gamma=False, eps=2e-5, momentum=0.9,
                             name=name)


def _residual_unit(pkg, data, num_filter, stride, dim_match, name,
                   bottleneck):
    """symbols/resnet.py's residual_unit: BN-relu-conv stack + shortcut."""
    conv = pkg.sym.Convolution
    bn1 = _resnet_bn(pkg, data, name + "_bn1")
    act1 = pkg.sym.Activation(bn1, act_type="relu", name=name + "_relu1")
    if bottleneck:
        conv1 = conv(act1, num_filter=num_filter // 4, kernel=(1, 1),
                     stride=(1, 1), pad=(0, 0), no_bias=True,
                     name=name + "_conv1")
        bn2 = _resnet_bn(pkg, conv1, name + "_bn2")
        act2 = pkg.sym.Activation(bn2, act_type="relu", name=name + "_relu2")
        conv2 = conv(act2, num_filter=num_filter // 4, kernel=(3, 3),
                     stride=stride, pad=(1, 1), no_bias=True,
                     name=name + "_conv2")
        bn3 = _resnet_bn(pkg, conv2, name + "_bn3")
        act3 = pkg.sym.Activation(bn3, act_type="relu", name=name + "_relu3")
        body = conv(act3, num_filter=num_filter, kernel=(1, 1),
                    stride=(1, 1), pad=(0, 0), no_bias=True,
                    name=name + "_conv3")
    else:
        conv1 = conv(act1, num_filter=num_filter, kernel=(3, 3),
                     stride=stride, pad=(1, 1), no_bias=True,
                     name=name + "_conv1")
        bn2 = _resnet_bn(pkg, conv1, name + "_bn2")
        act2 = pkg.sym.Activation(bn2, act_type="relu", name=name + "_relu2")
        body = conv(act2, num_filter=num_filter, kernel=(3, 3),
                    stride=(1, 1), pad=(1, 1), no_bias=True,
                    name=name + "_conv2")
    if dim_match:
        shortcut = data
    else:
        shortcut = conv(act1, num_filter=num_filter, kernel=(1, 1),
                        stride=stride, no_bias=True, name=name + "_sc")
    return body + shortcut


def resnet_plan(num_layers, image_h):
    """symbols/resnet.py's _plan: (units a stage, filters a stage,
    bottleneck?) for a depth; CIFAR-style at 64 px and below."""
    if image_h <= 64:
        if (num_layers - 2) % 9 == 0:
            n = (num_layers - 2) // 9
            return [n] * 3, [64, 128, 256], True
        if (num_layers - 2) % 6 == 0:
            n = (num_layers - 2) // 6
            return [n] * 3, [16, 32, 64], False
        raise ValueError("CIFAR resnet depth must satisfy "
                         "(num_layers-2) %% 9 == 0 or %% 6 == 0, got %d"
                         % num_layers)
    table = {18: ([2, 2, 2, 2], False), 34: ([3, 4, 6, 3], False),
             50: ([3, 4, 6, 3], True), 101: ([3, 4, 23, 3], True),
             152: ([3, 8, 36, 3], True), 200: ([3, 24, 36, 3], True)}
    if num_layers not in table:
        raise ValueError("no unit plan for resnet-%d at %dpx"
                         % (num_layers, image_h))
    units, bottleneck = table[num_layers]
    filters = [256, 512, 1024, 2048] if bottleneck else [64, 128, 256, 512]
    return units, filters, bottleneck


def resnet_symbol(pkg, num_layers=50, image_shape="3,224,224",
                  num_classes=1000, dtype="float32"):
    """symbols/resnet.py's get_symbol in either package, in a fresh name
    scope; its float16 variant (train_imagenet.py --dtype float16) casts
    the data to float16 and the last FullyConnected's output back."""
    c, h, w = (int(x) for x in image_shape.split(","))
    units, filters, bottleneck = resnet_plan(num_layers, h)
    with pkg.name.NameManager():
        data = pkg.sym.var("data")
        if dtype == "float16":
            data = pkg.sym.Cast(data, dtype="float16")
        body = _resnet_bn(pkg, data, "bn_data")
        if h <= 64:
            body = pkg.sym.Convolution(
                body, num_filter=filters[0] // (4 if bottleneck else 1),
                kernel=(3, 3), stride=(1, 1), pad=(1, 1), no_bias=True,
                name="conv0")
        else:
            body = pkg.sym.Convolution(body, num_filter=64, kernel=(7, 7),
                                       stride=(2, 2), pad=(3, 3),
                                       no_bias=True, name="conv0")
            body = _resnet_bn(pkg, body, "bn0")
            body = pkg.sym.Activation(body, act_type="relu", name="relu0")
            body = pkg.sym.Pooling(body, kernel=(3, 3), stride=(2, 2),
                                   pad=(1, 1), pool_type="max", name="pool0")
        for stage, (n_units, n_filter) in enumerate(zip(units, filters)):
            stride = (1, 1) if stage == 0 else (2, 2)
            body = _residual_unit(pkg, body, n_filter, stride, False,
                                  "stage%d_unit1" % (stage + 1), bottleneck)
            for unit in range(2, n_units + 1):
                body = _residual_unit(pkg, body, n_filter, (1, 1), True,
                                      "stage%d_unit%d" % (stage + 1, unit),
                                      bottleneck)
        body = _resnet_bn(pkg, body, "bn1")
        body = pkg.sym.Activation(body, act_type="relu", name="relu1")
        pool = pkg.sym.Pooling(body, global_pool=True, pool_type="avg",
                               kernel=(7, 7), name="pool1")
        flat = pkg.sym.Flatten(pool)
        fc = pkg.sym.FullyConnected(flat, num_hidden=num_classes, name="fc1")
        if dtype == "float16":
            fc = pkg.sym.Cast(fc, dtype="float32")
        return pkg.sym.SoftmaxOutput(fc, name="softmax")


def _inception_unit(pkg, x, channels, kernel, name, stride=(1, 1),
                    pad=(0, 0)):
    """symbols/inception_bn.py's _unit: conv -> BN -> relu."""
    x = pkg.sym.Convolution(x, num_filter=channels, kernel=kernel,
                            stride=stride, pad=pad, name=name + "_conv")
    x = pkg.sym.BatchNorm(x, fix_gamma=False, name=name + "_bn")
    return pkg.sym.Activation(x, act_type="relu", name=name + "_relu")


def _inception_tower(pkg, x, name, *stages):
    for k, (ch, kern, stride, pad) in enumerate(stages):
        x = _inception_unit(pkg, x, ch, kern, "%s_%d" % (name, k), stride,
                            pad)
    return x


def _inception_mixed(pkg, x, name, n1x1, n3r, n3, nd3r, nd3, pool, proj,
                     downsample=False):
    """symbols/inception_bn.py's _mixed: one Inception block."""
    stride = (2, 2) if downsample else (1, 1)
    towers = []
    if not downsample:
        towers.append(_inception_tower(pkg, x, name + "_b1",
                                       (n1x1, (1, 1), (1, 1), (0, 0))))
    towers.append(_inception_tower(pkg, x, name + "_b3",
                                   (n3r, (1, 1), (1, 1), (0, 0)),
                                   (n3, (3, 3), stride, (1, 1))))
    towers.append(_inception_tower(pkg, x, name + "_bd3",
                                   (nd3r, (1, 1), (1, 1), (0, 0)),
                                   (nd3, (3, 3), (1, 1), (1, 1)),
                                   (nd3, (3, 3), stride, (1, 1))))
    pooled = pkg.sym.Pooling(x, kernel=(3, 3), stride=stride, pad=(1, 1),
                             pool_type=pool, name=name + "_pool")
    if proj:
        pooled = _inception_unit(pkg, pooled, proj, (1, 1), name + "_bp")
    towers.append(pooled)
    return pkg.sym.Concat(*towers, name=name + "_concat")


# symbols/inception_bn.py's _PLAN: (name, n1x1, n3x3red, n3x3, nd3x3red,
# nd3x3, pool, proj, downsample)
INCEPTION_PLAN = [
    ("3a", 64, 64, 64, 64, 96, "avg", 32, False),
    ("3b", 64, 64, 96, 64, 96, "avg", 64, False),
    ("3c", 0, 128, 160, 64, 96, "max", 0, True),
    ("4a", 224, 64, 96, 96, 128, "avg", 128, False),
    ("4b", 192, 96, 128, 96, 128, "avg", 128, False),
    ("4c", 160, 128, 160, 128, 160, "avg", 128, False),
    ("4d", 96, 128, 192, 160, 192, "avg", 128, False),
    ("4e", 0, 128, 192, 192, 256, "max", 0, True),
    ("5a", 352, 192, 320, 160, 224, "avg", 128, False),
    ("5b", 352, 192, 320, 192, 224, "max", 128, False),
]


def inception_bn_symbol(pkg, num_classes=1000, image_shape="3,224,224"):
    """symbols/inception_bn.py's get_symbol in either package, in a fresh
    name scope (its small-image variant at 28 px and below)."""
    height = int(str(image_shape).split(",")[1])
    with pkg.name.NameManager():
        x = pkg.sym.Variable("data")
        if height <= 28:
            x = _inception_unit(pkg, x, 96, (3, 3), "stem", pad=(1, 1))
            small_plan = [("3a", 32, 32), ("3b", 32, 48), ("3c", 0, 80),
                          ("4a", 112, 48), ("4b", 96, 64), ("4c", 80, 80),
                          ("4d", 48, 96), ("4e", 0, 96), ("5a", 176, 160),
                          ("5b", 176, 160)]
            for name, c1, c3 in small_plan:
                if c1 == 0:
                    conv = _inception_unit(pkg, x, c3, (3, 3),
                                           name + "_conv", stride=(2, 2),
                                           pad=(1, 1))
                    pool = pkg.sym.Pooling(x, kernel=(3, 3), stride=(2, 2),
                                           pad=(1, 1), pool_type="max",
                                           name=name + "_pool")
                    x = pkg.sym.Concat(conv, pool, name=name + "_concat")
                else:
                    x = pkg.sym.Concat(
                        _inception_unit(pkg, x, c1, (1, 1), name + "_1x1"),
                        _inception_unit(pkg, x, c3, (3, 3), name + "_3x3",
                                        pad=(1, 1)),
                        name=name + "_concat")
            x = pkg.sym.Pooling(x, kernel=(7, 7), pool_type="avg",
                                name="global_pool")
        else:
            x = _inception_unit(pkg, x, 64, (7, 7), "stem1", stride=(2, 2),
                                pad=(3, 3))
            x = pkg.sym.Pooling(x, kernel=(3, 3), stride=(2, 2),
                                pool_type="max", name="pool1")
            x = _inception_tower(pkg, x, "stem2",
                                 (64, (1, 1), (1, 1), (0, 0)),
                                 (192, (3, 3), (1, 1), (1, 1)))
            x = pkg.sym.Pooling(x, kernel=(3, 3), stride=(2, 2),
                                pool_type="max", name="pool2")
            for row in INCEPTION_PLAN:
                x = _inception_mixed(pkg, x, *row)
            x = pkg.sym.Pooling(x, kernel=(7, 7), stride=(1, 1),
                                pool_type="avg", name="global_pool")
        x = pkg.sym.Flatten(x)
        x = pkg.sym.FullyConnected(x, num_hidden=num_classes, name="fc1")
        return pkg.sym.SoftmaxOutput(x, name="softmax")


def synthetic_data_iter(pkg, num_classes, data_shape, max_iter,
                        dtype="float32", ctx=None):
    """common/data.py's SyntheticDataIter in either package: one random
    batch from RandomState(0) (data uniform in [-1, 1), labels below
    ``num_classes``), served ``max_iter`` times an epoch; its arrays on
    the current context unless ``ctx``."""
    class SyntheticDataIter(pkg.io.DataIter):
        def __init__(self):
            super().__init__(data_shape[0])
            self.cur_iter = 0
            self.max_iter = int(max_iter)
            rng = np.random.RandomState(0)
            where = {} if ctx is None else {"ctx": ctx}
            self._data = pkg.nd.array(
                rng.uniform(-1, 1, data_shape).astype(dtype), **where)
            self._label = pkg.nd.array(
                rng.randint(0, num_classes, (data_shape[0],)).astype(dtype),
                **where)
            self._dtype = dtype

        @property
        def provide_data(self):
            return [pkg.io.DataDesc("data", self._data.shape, self._dtype)]

        @property
        def provide_label(self):
            return [pkg.io.DataDesc("softmax_label", self._label.shape,
                                    self._dtype)]

        def next(self):
            self.cur_iter += 1
            if self.cur_iter > self.max_iter:
                raise StopIteration
            return pkg.io.DataBatch(data=[self._data], label=[self._label],
                                    pad=0, provide_data=self.provide_data,
                                    provide_label=self.provide_label)

        def reset(self):
            self.cur_iter = 0
    return SyntheticDataIter()


# train_imagenet.py's defaults and fit.py's (the options its --benchmark 1
# run leaves as they are)
IMAGENET_ARGS = dict(lr=0.1, lr_factor=0.1, lr_step_epochs="30,60",
                     mom=0.9, wd=1e-4, disp_batches=20)


def fit_lr_scheduler(pkg, lr, lr_factor, lr_step_epochs, num_examples,
                     batch_size):
    """fit.py's _get_lr_scheduler for a run from epoch 0 on one worker:
    (lr, MultiFactorScheduler at the epochs of lr_step_epochs), or (lr,
    None) without a factor below 1."""
    if lr_factor is None or lr_factor >= 1:
        return lr, None
    epoch_size = num_examples / batch_size
    steps = [int(epoch_size * int(x)) for x in lr_step_epochs.split(",")]
    return lr, pkg.lr_scheduler.MultiFactorScheduler(step=steps,
                                                     factor=lr_factor)


def fit_initializer(pkg, initializer="default", network=None):
    """common/fit.py's _select_initializer (fit.py:125-137) in either
    package: its table looked up by the --initializer name."""
    if initializer == "default":
        if network == "alexnet":
            return pkg.init.Normal()
        if "vgg" in (network or ""):
            return pkg.init.Xavier()
        return pkg.init.Xavier(rnd_type="gaussian", factor_type="in",
                               magnitude=2)
    table = {"xavier": pkg.init.Xavier, "msra": pkg.init.MSRAPrelu,
             "orthogonal": pkg.init.Orthogonal, "normal": pkg.init.Normal,
             "uniform": pkg.init.Uniform, "one": pkg.init.One,
             "zero": pkg.init.Zero}
    return table[initializer]()


def fit_metrics(pkg, top_k=0, loss=""):
    """common/fit.py's _eval_metrics (fit.py:140-151) in either package:
    accuracy, top-k accuracy with --top-k, and the --loss list's ce / nll
    ("nll" names nll_loss)."""
    metrics = [pkg.metric.create("accuracy")]
    if top_k > 0:
        metrics.append(pkg.metric.create("top_k_accuracy", top_k=top_k))
    for loss_type in filter(None, (s.strip() for s in loss.split(","))):
        if loss_type == "nll":
            loss_type = "nll_loss"
        if loss_type in ("ce", "nll_loss"):
            metrics.append(pkg.metric.create(loss_type))
        else:
            logging.warning("%s is not a valid loss type", loss_type)
    return metrics


def fit_call(pkg, network, train, val, kv, num_epoch, lr, lr_scheduler,
             mom, wd, batch_size, disp_batches, context=None,
             arg_params=None, aux_params=None, batch_end_callback=None,
             eval_end_callback=None, optimizer="sgd", initializer=None,
             eval_metric=None):
    """common/fit.py's Module.fit call (fit.py:200-232) in either package,
    for a run from epoch 0 with no checkpoint prefix and no monitor: Module
    on ``context`` (fit.py hard-codes cpu(); the card runs pass gpu(0)),
    ``optimizer`` (SGD by default) with ``lr`` / ``wd``, ``mom`` where
    fit.py passes it (sgd, dcasgd, nag), multi_precision and the
    scheduler, ``eval_metric`` (accuracy by default), ``initializer``
    (fit.py's default, Xavier(gaussian, in, 2), if None),
    Speedometer(batch, disp_batches) and allow_missing, from given weights
    ({name: numpy}) if any. The callbacks after Speedometer observe the
    run; fit.py passes none. Returns the module."""
    model = pkg.mod.Module(context=context or pkg.context.current_context(),
                           symbol=network)
    optimizer_params = {"learning_rate": lr, "wd": wd,
                        "lr_scheduler": lr_scheduler,
                        "multi_precision": True}
    if optimizer in ("sgd", "dcasgd", "nag"):
        optimizer_params["momentum"] = mom
    callbacks = [pkg.callback.Speedometer(batch_size, disp_batches)]
    callbacks += list(batch_end_callback or [])
    model.fit(train, begin_epoch=0, num_epoch=num_epoch, eval_data=val,
              eval_metric=eval_metric or [pkg.metric.create("accuracy")],
              kvstore=kv, optimizer=optimizer,
              optimizer_params=optimizer_params,
              initializer=initializer or fit_initializer(pkg),
              arg_params=host_params(pkg, arg_params),
              aux_params=host_params(pkg, aux_params),
              batch_end_callback=callbacks, epoch_end_callback=None,
              eval_end_callback=eval_end_callback,
              allow_missing=True, monitor=None)
    return model


def imagenet_fit(pkg, network, batch_size, num_examples, num_epoch,
                 image_shape="3,224,224", num_classes=1000, context=None,
                 kvstore=None, arg_params=None, aux_params=None,
                 batch_end_callback=None, data_ctx=None, optimizer="sgd",
                 initializer="default", top_k=0, loss=""):
    """train_imagenet.py --benchmark 1's run of fit.py's fit() in either
    package: SyntheticDataIter's fixed batch, the kvstore object that
    fit.py creates from --kv-store "device" (or ``kvstore`` as given:
    "local" by name means no store on one device, so the fused step may
    engage), and fit_call with SGD lr 0.1 / momentum 0.9 / wd 1e-4 and the
    MultiFactorScheduler of lr_step_epochs "30,60", Speedometer(batch,
    20); ``optimizer``, ``initializer``, ``top_k`` and ``loss`` are
    fit.py's --optimizer, --initializer, --top-k and --loss. Returns
    (module, train iterator)."""
    a = IMAGENET_ARGS
    kv = pkg.kvstore.create("device") if kvstore is None else kvstore
    shape = tuple(int(x) for x in image_shape.split(","))
    train = synthetic_data_iter(pkg, num_classes, (batch_size,) + shape,
                                num_examples / batch_size, ctx=data_ctx)
    lr, lr_scheduler = fit_lr_scheduler(pkg, a["lr"], a["lr_factor"],
                                        a["lr_step_epochs"], num_examples,
                                        batch_size)
    model = fit_call(pkg, network, train, None, kv, num_epoch, lr,
                     lr_scheduler, a["mom"], a["wd"], batch_size,
                     a["disp_batches"], context, arg_params, aux_params,
                     batch_end_callback, optimizer=optimizer,
                     initializer=fit_initializer(pkg, initializer),
                     eval_metric=fit_metrics(pkg, top_k, loss))
    return model, train


def module_aux(mod):
    """A Module's aux states (the moving statistics) as {name: numpy}."""
    return {k: v.asnumpy() for k, v in mod.get_params()[1].items()}


# The full-width run: ResNet-50 at 3x224x224, 1,000 classes, the example's
# batch of 128, f32. --num-examples is cut so that an epoch is RN_STEPS
# steps (train_imagenet.py's 1,281,167 images make 10,009), and each path
# trains RN_EPOCHS epochs; the lr schedule's steps (epochs 30 and 60) then
# lie beyond the run, as they lie beyond an epoch of the full run. With
# TF32 off each path trains one epoch of RN_OFF_STEPS steps (its times
# only), and every timed turn is RN_TIMED_STEPS steps.
RN_BATCH, RN_SHAPE, RN_CLASSES = 128, "3,224,224", 1000
RN_STEPS, RN_EPOCHS, RN_OFF_STEPS, RN_TIMED_STEPS = 20, 2, 5, 5
# The first steps card vs CPU, at a batch the CPU takes in seconds.
RN_CHECK_BATCH = 16
# The float32 gradient of these networks is discontinuous in the forward's
# rounding: a ReLU whose input lies within rounding of 0 flips its mask,
# and one element of a batch of 16 is a large share of a channel's
# gradient. On the CPU, changing only the thread count moved the port's
# own Inception-BN gradients by 13% of a parameter's largest, and mxtpu's
# float32 weights after 3 steps of ResNet-20 lie 0.36 of a step from a
# float64 run (tests/test_torch_resnet.py). So weights after the first
# step, card vs CPU, agree within RN_STEP_SHARE of the largest distance a
# weight of that parameter moved in it, plus RN_ATOL for the conv biases
# before a BatchNorm (Inception-BN's), whose exact gradient is 0. Later
# steps start from weights already apart, and at lr 0.1 a difference
# grows step by step: after FIT_STEPS steps the CPU alone, started from
# weights one ulp apart, ends 0.677 of its move apart (the norm of the
# weights' difference over the norm of their move; ResNet-50, batch 16).
# There the card is held to the CPU within RN_SPREAD times what that
# one-ulp start makes the CPU differ from itself in the same run: the
# weights' and the moving statistics' norm shares and each step's loss.
# The moving
# statistics after one step come from the forward alone: a batch mean or
# variance of activations whose float32 convolutions (sums of up to 4,608
# products, 2.7e-4 relative at worst, about 4e-6 as a random walk) differ
# in order; through 50 layers, which BatchNorm keeps near unit scale, that
# stays below RN_AUX_TOL of the largest statistic of a layer.
RN_STEP_SHARE = 0.5
RN_ATOL = 1e-5
RN_SPREAD = 2.0
RN_AUX_TOL = 1e-3
# Steps of the captured path held against the eager one on the card (both
# with cuDNN's deterministic algorithms): the same kernels on the same
# inputs; only lr becomes a float32 device scalar, so CAPTURE_TOL.
RN_CAPTURE_STEPS = 6
# The fixed batch (SyntheticDataIter serves one batch) is learnt: the last
# epoch's mean training cross-entropy must fall below this share of the
# first epoch's (ln 1000 = 6.9 at the start).
RN_CE_SHARE = 0.5
# imagenet_first_steps' runs: card, CPU and the CPU from weights one ulp
# apart, each this many steps (the later steps' check is against the same
# steps' ulp spread, so it holds at any count)
RN_FIRST_STEPS = 2
# Inception-BN's short captured epoch at the full batch
INCEPTION_STEPS = 5
# Steps under torch.profiler for a full-width path's busy share (a whole
# epoch's trace took most of a minute to gather)
RN_PROFILE_STEPS = 2
# Peak rates of one H100 SXM (dense, at 700 W): float32 outside the tensor
# cores, TF32 on them, and HBM bandwidth.
PEAK_F32, PEAK_TF32 = 67e12, 495e12


class StepLosses:
    """A fit's batch_end_callback: each step's cross-entropy of its batch,
    from the step's outputs (the softmax), kept on the card until read,
    so that no step waits for the card."""

    def __init__(self):
        self.steps = []             # (epoch, 0-dim tensor)

    def __call__(self, param):
        import torch
        mod, batch = param.locals["self"], param.locals["batch"]
        prob = mod.get_outputs()[0].data.float()
        label = batch.label[0].data.to(prob.device).long()
        self.steps.append((param.epoch, -torch.log(
            prob.gather(1, label[:, None]).clamp_min(1e-12)).mean()))

    def values(self):
        return [float(v) for _, v in self.steps]

    def epoch_means(self):
        by_epoch = {}
        for (e, _), v in zip(self.steps, self.values()):
            by_epoch.setdefault(e, []).append(v)
        return [float(np.mean(by_epoch[e])) for e in sorted(by_epoch)]


def imagenet_init_params(mt, network, batch, image_shape, seed):
    """fit.py's Xavier draws for ``network``, made by the port's Module on
    the CPU from ``seed``: ({name: numpy} args, {name: numpy} aux)."""
    dims = tuple(int(x) for x in image_shape.split(","))
    mt.random.seed(seed)
    mod = mt.mod.Module(network, context=mt.cpu())
    mod.bind([("data", (batch,) + dims)], [("softmax_label", (batch,))])
    mod.init_params(mt.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2))
    args, auxs = mod.get_params()
    return ({k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in auxs.items()})


def step_share_check(label, got, want, start, share, atol):
    """Fail unless every array of ``got`` lies within ``share`` of the
    largest distance that array moved from ``start`` in ``want``, plus
    ``atol``. Returns the largest |got - want| over that limit."""
    worst = 0.0
    for k in sorted(want):
        step = float(np.abs(want[k] - start[k]).max())
        diff = float(np.abs(got[k] - want[k]).max())
        if diff > share * step + atol:
            fail("%s: %s differs by %.3g, beyond %.2f of its step %.3g + %g"
                 % (label, k, diff, share, step, atol))
        worst = max(worst, diff / (share * step + atol))
    return worst


def norm_share(got, want, start):
    """||got - want|| / ||want - start|| over every array of the dicts:
    how far two runs ended apart, as a share of how far they moved."""
    apart = sum(float(np.square(got[k] - want[k]).sum()) for k in want)
    moved = sum(float(np.square(want[k] - start[k]).sum()) for k in want)
    return (apart / moved) ** 0.5 if moved else float(apart > 0)


def ulp_apart(params, seed):
    """{name: numpy} with every value moved by one ulp up or down (float32:
    a relative 2^-23), the sign drawn from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    return {k: (v * (1 + 2.0 ** -23 * rng.choice([-1, 1], v.shape)))
            .astype(v.dtype) for k, v in sorted(params.items())}


def imagenet_first_steps(mt, label, build, image_shape, seed):
    """The first steps of imagenet_fit at RN_CHECK_BATCH, TF32 off, on the
    card (gpu(0), the kvstore object's eager path) against the port's CPU
    Module. After 1 step: each weight within RN_STEP_SHARE of its
    parameter's step (plus RN_ATOL), the moving statistics within
    RN_AUX_TOL. After RN_FIRST_STEPS steps, where float32 rounding alone
    sends runs apart: the weights' and the moving statistics' distance
    from the CPU's, as a share of their move (``norm_share``), and each
    step's loss, within RN_SPREAD times what the CPU itself gives from
    weights one ulp apart (plus RN_AUX_TOL of the loss, the forward's
    rounding at the first step). Each reading printed."""
    gpu = mt.gpu(0)
    args0, aux0 = imagenet_init_params(mt, build(mt), RN_CHECK_BATCH,
                                       image_shape, seed)
    where = "%s first steps at batch %d, card vs the CPU's Module" % (
        label, RN_CHECK_BATCH)

    def run(ctx, steps, args):
        """The weights, moving statistics and losses after ``steps``
        steps, and the weights and statistics after the first."""
        np.random.seed(seed)
        losses = StepLosses()
        first = []

        def after_first(param):
            if param.nbatch == 0:
                m = param.locals["self"]
                first.append((module_params(m), module_aux(m)))
        mod, _ = imagenet_fit(mt, build(mt), RN_CHECK_BATCH,
                              RN_CHECK_BATCH * steps, 1, image_shape,
                              RN_CLASSES, context=ctx, arg_params=args,
                              aux_params=aux0, data_ctx=ctx,
                              batch_end_callback=[losses, after_first])
        return (module_params(mod), module_aux(mod), losses.values()) + \
            first[0]

    # the first step's check reads the RN_FIRST_STEPS runs after their
    # first step
    card = run(gpu, RN_FIRST_STEPS, args0)
    cpu = run(mt.cpu(), RN_FIRST_STEPS, args0)
    (g_args, g_aux), (c_args, c_aux) = card[3:], cpu[3:]
    w = step_share_check(where + ", 1 step", g_args, c_args, args0,
                         RN_STEP_SHARE, RN_ATOL)
    aux_err = max(float(np.abs(g_aux[k] - c_aux[k]).max()
                        / np.abs(c_aux[k]).max()) for k in c_aux)
    if aux_err > RN_AUX_TOL:
        fail("%s: moving statistics after 1 step differ by %.3g of a "
             "layer's largest (limit %g)" % (where, aux_err, RN_AUX_TOL))
    print("%s: 1 step: the weights use %.3g of their limit (%.2f of their "
          "parameter's step + %g), moving statistics within %.3g of a "
          "layer's largest (limit %g)" % (where, w, RN_STEP_SHARE, RN_ATOL,
                                          aux_err, RN_AUX_TOL), flush=True)

    ulp = run(mt.cpu(), RN_FIRST_STEPS, ulp_apart(args0, seed))
    readings = []
    for i, (what, start) in enumerate((("weights", args0),
                                       ("moving statistics", aux0))):
        got = norm_share(card[i], cpu[i], start)
        spread = norm_share(ulp[i], cpu[i], start)
        if not got <= RN_SPREAD * spread + RN_AUX_TOL:
            fail("%s: %s after %d steps apart by %.3g of their move; the "
                 "CPU from weights one ulp apart: %.3g (limit %g times it)"
                 % (where, what, RN_FIRST_STEPS, got, spread, RN_SPREAD))
        readings.append("%s %.3g (the CPU one ulp apart: %.3g)"
                        % (what, got, spread))
    for k, (g, c, u) in enumerate(zip(card[2], cpu[2], ulp[2])):
        if not abs(g - c) <= RN_SPREAD * abs(u - c) + RN_AUX_TOL * c:
            fail("%s: the loss of step %d is %.6f on the card, %.6f on the "
                 "CPU (%.6f from weights one ulp apart)"
                 % (where, k + 1, g, c, u))
    print("%s: %d steps: apart by a share of their move: %s (limit %g "
          "times the CPU's own); losses card %s, CPU %s, one ulp apart %s"
          % (where, RN_FIRST_STEPS, "; ".join(readings), RN_SPREAD,
             ", ".join("%.5f" % x for x in card[2]),
             ", ".join("%.5f" % x for x in cpu[2]),
             ", ".join("%.5f" % x for x in ulp[2])), flush=True)


def capture_report(mod, steps, label):
    """The captured fit's counts: fail unless every step ran fused, with
    one compile (a real first step) and one capture a signature, a replay
    in every later step and no fallback. (fit.py's metric list makes a
    composite metric, which stays on the host, so the key has no metric:
    one signature.) Returns (text, entries with a graph)."""
    trainer = mod._fused
    if trainer is None:
        fail("%s: the fused step is not engaged (%s)"
             % (label, getattr(mod, "_fused_fallback_logged", "disabled")))
    stats = trainer._group.stats
    entries = trainer._cache.entries()
    replays = sum(e.replays for e in entries)
    want = {"steps": steps, "compiles": len(entries),
            "cache_hits": steps - len(entries), "fallbacks": 0}
    if {k: stats[k] for k in want} != want or \
            replays != steps - len(entries) or \
            any(e.graph is None for e in entries):
        fail("%s: fused stats %s, %d replays over %d signatures (want %s, "
             "a graph each)" % (label, stats, replays, len(entries), want))
    return ("%d steps: %d compile(s), %d capture(s), %d replays, pool %s MB"
            % (steps, len(entries), len(entries), replays,
               ", ".join("%.1f" % (e.pool_bytes / 2 ** 20)
                         for e in entries)), entries)


def step_bound(mt, mod, batch, classes=RN_CLASSES):
    """The least time one training step could take at the card's peaks,
    from one eager forward_backward + update of ``mod`` counted by torch's
    FlopCounterMode (the convolutions and the matmuls: their FLOPs) and the
    bytes a step must move (the batch, every weight, momentum and moving
    statistic read once and written once, the ``classes`` outputs a row
    written). Returns (conv FLOPs, matmul FLOPs, bytes)."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        mod.forward_backward(batch)
        mod.update()
    by_op = counter.get_flop_counts().get("Global", {})
    conv = sum(v for k, v in by_op.items() if "convolution" in str(k))
    matmul = counter.get_total_flops() - conv
    args, auxs = mod.get_params()
    n_param = sum(v.size for v in args.values())
    n_aux = sum(v.size for v in auxs.values())
    nbytes = 4 * (sum(int(np.prod(d.shape)) for d in batch.data)
                  + batch.label[0].size + 2 * (2 * n_param + n_aux)
                  + batch.data[0].shape[0] * classes)
    return conv, matmul, nbytes


def bound_ms(flops, nbytes, tf32):
    """(ms, "operations" or "bytes") for a step's FLOPs and bytes: the
    convolutions at TF32's or float32's peak, the matmuls (TF32 stays off
    for them, torch's default) at float32's."""
    conv, matmul = flops
    ops = (conv / (PEAK_TF32 if tf32 else PEAK_F32) + matmul / PEAK_F32) \
        * 1e3
    mem = nbytes / PEAK_BYTES_S * 1e3
    return (ops, "operations") if ops >= mem else (mem, "bytes")


@contextlib.contextmanager
def tf32_mode(on):
    """cuDNN's TF32 as torch's default leaves it (on) or off; matmuls stay
    at torch's default, off."""
    import torch
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = old


def resnet_times(mt, runs, setting, card, flops, nbytes):
    """ms a step of fit's loop body, eager and captured in turns (eager,
    captured, captured, eager), with the host time by phase, images/s and
    the share of the bound, then the card's busy share, kernels and host
    launch calls a step from torch.profiler over RN_PROFILE_STEPS steps.
    ``runs``: {"eager": (module, iterator), "captured": ...}. Returns
    {path: ms}."""
    import torch
    metrics = {k: mt.metric.create([mt.metric.create("accuracy")])
               for k in runs}
    ms = {k: [] for k in runs}
    clock = {k: {} for k in runs}
    steps = 0
    for k in ("eager", "captured", "captured", "eager"):
        mod, it = runs[k]
        it.max_iter = RN_TIMED_STEPS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = fit_epoch(mod, it, metrics[k], clock[k])
        torch.cuda.synchronize()
        ms[k].append((time.perf_counter() - t0) / steps * 1e3)
    tf32 = setting == "TF32 on"
    bound, by = bound_ms(flops, nbytes, tf32)
    out = {}
    for k, (mod, it) in runs.items():
        step = float(np.mean(ms[k]))
        out[k] = step
        host = "; ".join("%s %.3f" % (p, v / (2 * steps) * 1e3)
                         for p, v in clock[k].items())
        it.max_iter = RN_PROFILE_STEPS
        try:
            busy, top = device_time(lambda: fit_epoch(mod, it, metrics[k]),
                                    1, per=RN_PROFILE_STEPS)
        finally:
            it.max_iter = steps
        print("ResNet-50 %s step, %s (cuDNN TF32 %s, matmul TF32 off): "
              "%.3f ms (%s), %.1f images/s; bound %.3f ms (%s), %.1f%% of "
              "it; host ms a step by phase: %s; %s; per step: %s | %s"
              % (k, setting, "on" if tf32 else "off", step,
                 ", ".join("%.3f" % v for v in ms[k]), RN_BATCH / step * 1e3,
                 bound, by, 100 * bound / step, host, busy_of(busy, step),
                 top, card))
    print("ResNet-50 step, %s: eager %.3f ms, captured %.3f ms (%.2fx) | %s"
          % (setting, out["eager"], out["captured"],
             out["eager"] / out["captured"], card))
    return out


def resnet_full_width(mt, resnet50, seed, card, tf32, setting, bound):
    """ResNet-50 at full width on gpu(0) under one TF32 setting: the fit
    call eager (fit.py's kvstore object) and captured (kvstore="local"),
    RN_EPOCHS epochs under torch's default TF32 (the fixed batch's
    cross-entropy must fall below RN_CE_SHARE of the first epoch's), one
    epoch of RN_OFF_STEPS with TF32 off; the captured counts, no host wait in a captured epoch,
    then both steps timed in turns (resnet_times). Under the default it
    also counts the step's FLOPs and bytes (``bound``, reused for the
    other setting) and checks the checkpoint on the CPU. Returns ({path:
    ms a step}, bound)."""
    import torch
    gpu = mt.gpu(0)
    runs, ce = {}, {}
    epochs = RN_EPOCHS if tf32 else 1
    epoch_steps = RN_STEPS if tf32 else RN_OFF_STEPS
    with tf32_mode(tf32):
        for path, kv in (("eager", None), ("captured", "local")):
            torch.cuda.reset_peak_memory_stats()
            ce[path] = StepLosses()
            np.random.seed(seed)
            mt.random.seed(seed)
            t0 = time.perf_counter()
            mod, it = imagenet_fit(mt, resnet50(mt), RN_BATCH,
                                   epoch_steps * RN_BATCH, epochs, RN_SHAPE,
                                   RN_CLASSES, context=gpu, kvstore=kv,
                                   batch_end_callback=[ce[path]])
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            if mod._context != [gpu]:
                fail("ResNet-50's Module context is %s, not gpu(0)"
                     % mod._context)
            text = "eager (the kvstore object fit.py makes)"
            if path == "captured":
                text, entries = capture_report(
                    mod, epochs * epoch_steps, "ResNet-50 " + setting)
                text += "; graph (kernel nodes, other nodes, -, replays): " \
                    "%s" % graph_nodes(mt, entries, {}, gpu)
                del entries
            means = ce[path].epoch_means()
            if not all(np.isfinite(means)):
                fail("ResNet-50 %s fit: cross-entropy %s" % (path, means))
            if tf32 and not means[-1] < RN_CE_SHARE * means[0]:
                fail("ResNet-50 %s fit: the fixed batch's mean training "
                     "cross-entropy went from %.4f to %.4f (limit %.2f of "
                     "the first epoch's)" % (path, means[0], means[-1],
                                             RN_CE_SHARE))
            print("ResNet-50 Module.fit %s, %s: %d epoch(s) of %d steps at "
                  "batch %d in %.2f s; training cross-entropy by epoch %s "
                  "(limit %.2f of the first); %s; peak memory %.2f GB | %s"
                  % (path, setting, epochs, epoch_steps, RN_BATCH, fit_s,
                     ", ".join("%.4f" % m for m in means), RN_CE_SHARE,
                     text, torch.cuda.max_memory_allocated() / 1e9, card),
                  flush=True)
            runs[path] = (mod, it)
        if bound is None:
            mod, it = runs["eager"]
            it.reset()
            conv, matmul, nbytes = step_bound(mt, mod, next(iter(it)))
            bound = ((conv, matmul), nbytes)
            print("ResNet-50 step at batch %d: %.4g conv FLOPs + %.4g matmul "
                  "FLOPs (FlopCounterMode over one eager step; %.3g GMAC an "
                  "image forward), %.4g bytes to move at least; bound %.3f "
                  "ms with cuDNN TF32, %.3f ms in float32 | %s"
                  % (RN_BATCH, conv, matmul, (conv + matmul) / 6 / RN_BATCH
                     / 1e9, nbytes, bound_ms(*bound, True)[0],
                     bound_ms(*bound, False)[0], card), flush=True)
        no_sync_epoch(*runs["captured"],
                      mt.metric.create([mt.metric.create("accuracy")]))
        times = resnet_times(mt, runs, setting, card, *bound)
        if tf32:
            resnet_checkpoint(mt, *runs["captured"])
    return times, bound


def resnet_phase(mt, seed, card):
    """train_imagenet.py --benchmark 1's fit call on the card (context
    gpu(0), where fit.py hard-codes cpu()): its first steps against the
    CPU, captured steps against eager ones, the full-width run (ResNet-50
    at 224, batch 128) eager and captured under torch's default TF32 and
    with TF32 off, its checkpoint on the CPU, and Inception-BN. Returns
    ({(path, setting): ms a step}, the step's ((conv, matmul) FLOPs,
    bytes))."""
    import gc
    import torch
    gpu = mt.gpu(0)
    clock = [("start", time.perf_counter())]

    def resnet50(pkg):
        return resnet_symbol(pkg, 50, RN_SHAPE, RN_CLASSES)

    # the first steps, card vs CPU (TF32 off, as main leaves it)
    imagenet_first_steps(mt, "ResNet-50", resnet50, RN_SHAPE, seed)
    clock.append(("first steps", time.perf_counter()))

    # captured against eager on the card, deterministic cuDNN
    args0, aux0 = imagenet_init_params(mt, resnet50(mt), RN_CHECK_BATCH,
                                       RN_SHAPE, seed)
    got = {}
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for kv in (None, "local"):
            np.random.seed(seed)
            mod, _ = imagenet_fit(mt, resnet50(mt), RN_CHECK_BATCH,
                                  RN_CHECK_BATCH * RN_CAPTURE_STEPS, 1,
                                  RN_SHAPE, RN_CLASSES, context=gpu,
                                  kvstore=kv, arg_params=args0,
                                  aux_params=aux0)
            if kv == "local":
                text = capture_report(mod, RN_CAPTURE_STEPS,
                                      "ResNet-50 capture check")[0]
            got[kv] = (module_params(mod), module_aux(mod))
            del mod
    finally:
        torch.backends.cudnn.deterministic = old
    for i, what in enumerate(("weights", "moving statistics")):
        names = sorted(got[None][i])
        check_close("ResNet-50: %d captured steps vs eager ones on the card "
                    "(deterministic cuDNN), %s" % (RN_CAPTURE_STEPS, what),
                    [torch.from_numpy(got["local"][i][k]) for k in names],
                    [torch.from_numpy(got[None][i][k]) for k in names],
                    CAPTURE_TOL)
    print("ResNet-50 captured vs eager at batch %d (deterministic cuDNN): %s;"
          " max |diff| weights %.3g, moving statistics %.3g (tolerance %s)"
          % (RN_CHECK_BATCH, text,
             max(float(np.abs(got["local"][0][k] - got[None][0][k]).max())
                 for k in got[None][0]),
             max(float(np.abs(got["local"][1][k] - got[None][1][k]).max())
                 for k in got[None][1]), CAPTURE_TOL))
    del got
    gc.collect()
    torch.cuda.empty_cache()
    clock.append(("capture check", time.perf_counter()))

    # the full-width run, torch's default TF32 (cuDNN's convolutions in
    # TF32, matmuls in float32), then TF32 off; each run's modules and
    # graphs are freed before the next
    out, bound = {}, None
    for tf32, setting in ((True, "TF32 on"), (False, "TF32 off")):
        times, bound = resnet_full_width(mt, resnet50, seed, card, tf32,
                                         setting, bound)
        for path, ms in times.items():
            out[path, setting] = ms
        gc.collect()
        torch.cuda.empty_cache()
        clock.append(("full width, " + setting, time.perf_counter()))

    # Inception-BN: its first steps against the CPU, then a short captured
    # epoch at the full batch
    def inception(pkg):
        return inception_bn_symbol(pkg, RN_CLASSES, RN_SHAPE)
    imagenet_first_steps(mt, "Inception-BN", inception, RN_SHAPE, seed)
    ce = StepLosses()
    np.random.seed(seed)
    t0 = time.perf_counter()
    mod, it = imagenet_fit(mt, inception(mt), RN_BATCH,
                           INCEPTION_STEPS * RN_BATCH, 1, RN_SHAPE,
                           RN_CLASSES, context=gpu, kvstore="local",
                           batch_end_callback=[ce])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    text = capture_report(mod, INCEPTION_STEPS, "Inception-BN")[0]
    if not np.isfinite(ce.epoch_means()[0]):
        fail("Inception-BN: cross-entropy %s" % ce.epoch_means())
    metric = mt.metric.create([mt.metric.create("accuracy")])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = fit_epoch(mod, it, metric)
    torch.cuda.synchronize()
    step = (time.perf_counter() - t0) / steps * 1e3
    print("Inception-BN Module.fit captured (cuDNN TF32 on): %d steps at "
          "batch %d in %.2f s, %s; training cross-entropy %.4f; then %.3f ms "
          "a step, %.1f images/s | %s"
          % (INCEPTION_STEPS, RN_BATCH, secs, text, ce.epoch_means()[0], step,
             RN_BATCH / step * 1e3, card))
    out["captured", "Inception-BN"] = step
    del mod, it
    gc.collect()
    torch.cuda.empty_cache()
    clock.append(("Inception-BN", time.perf_counter()))
    print("ResNet phase: %.1f s (%s)" % (
        clock[-1][1] - clock[0][1], ", ".join(
            "%s %.1f" % (name, t - clock[i][1])
            for i, (name, t) in enumerate(clock[1:]))))
    return out, bound


def resnet_checkpoint(mt, mod, it):
    """The trained module's checkpoint (its moving statistics as aux:
    entries) loaded into a CPU Module predicts the fixed batch's first
    RN_CHECK_BATCH images as the card does (TF32 off on the card),
    within SERVE_TOL."""
    import tempfile
    import torch
    it.reset()
    batch = next(iter(it))
    it.reset()
    x = batch.data[0].asnumpy()[:RN_CHECK_BATCH]
    y = batch.label[0].asnumpy()[:RN_CHECK_BATCH]
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "resnet50")
        mod.save_checkpoint(prefix, RN_EPOCHS)
        preds = {}
        for ctx in (mt.gpu(0), mt.cpu()):
            loaded = mt.mod.Module.load(prefix, RN_EPOCHS, context=ctx)
            loaded.bind([("data", x.shape)], [("softmax_label", y.shape)],
                        for_training=False)
            with tf32_mode(False):
                preds[ctx] = loaded.predict(mt.io.NDArrayIter(
                    x, y, RN_CHECK_BATCH)).asnumpy()
    got, want = preds[mt.gpu(0)], preds[mt.cpu()]
    check_close("ResNet-50's checkpoint: the card's predictions vs the CPU's",
                [torch.from_numpy(got)], [torch.from_numpy(want)], SERVE_TOL)
    agree = float((got.argmax(1) == want.argmax(1)).mean())
    print("ResNet-50 checkpoint (%d aux states) on the CPU: max |card - cpu| "
          "over %d predictions %.3g (tolerance %s); argmax agrees on %.0f%%, "
          "train accuracy on them %.3f"
          % (len(mod.get_params()[1]), x.shape[0],
             float(np.abs(got - want).max()), SERVE_TOL, 100 * agree,
             float((want.argmax(1) == y).mean())))


def fit_times(mt, eager, captured, card):
    """ms a step of fit's loop body (host clock, synchronized), eager and
    captured in turns (eager, captured, captured, eager) on each model,
    with the host time of each phase, the card's busy share and the
    launches a step. Returns {label: {"eager": ms, "captured": ms}}."""
    import torch
    out = {}
    for label in ("MLP", "LeNet"):
        runs = {"eager": eager[label], "captured": captured[label]}
        metrics = {k: mt.metric.create("acc") for k in runs}
        for k, (mod, it) in runs.items():
            fit_epoch(mod, it, metrics[k])
        ms = {k: [] for k in runs}
        clock = {k: {} for k in runs}
        for k in ("eager", "captured", "captured", "eager"):
            mod, it = runs[k]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps = fit_epoch(mod, it, metrics[k], clock[k])
            torch.cuda.synchronize()
            ms[k].append((time.perf_counter() - t0) / steps * 1e3)
        out[label] = {k: float(np.mean(v)) for k, v in ms.items()}
        for k, (mod, it) in runs.items():
            step = out[label][k]
            host = "; ".join("%s %.3f" % (p, v / (2 * steps) * 1e3)
                             for p, v in clock[k].items())
            busy, top = device_time(
                lambda: fit_epoch(mod, it, metrics[k]), 1, per=steps)
            print("Module.fit %s %s step: %.3f ms (two epochs of %d steps: "
                  "%s, host clock, synchronized); host ms a step by phase: "
                  "%s; %s; per step: %s | %s"
                  % (label, k, step, steps,
                     ", ".join("%.3f" % v for v in ms[k]), host,
                     busy_of(busy, step), top, card))
        print("Module.fit %s step: eager %.3f ms, captured %.3f ms (%.2fx) "
              "| %s" % (label, out[label]["eager"], out[label]["captured"],
                        out[label]["eager"] / out[label]["captured"], card))
    return out


# ---------------------------------------------------------------------------
# The Gluon slice (BASELINE.json config 3, "Gluon hybridize() ResNet-18 +
# autograd imperative mode"): gluon.model_zoo.vision.resnet18_v1 trained by
# example/gluon/mnist.py's loop (autograd.record, backward, Trainer.step)
# over a DataLoader, eager and hybridized; the Gluon LSTM LM of
# example/gluon/word_language_model.py (B4 every forward) and a GRU variant
# (B5); the hybridized MLP of example/gluon/mnist.py. The examples import
# mxtpu, so their models and loops are mirrored here for either package.
# ---------------------------------------------------------------------------

# ResNet-18 v1 at its published widths: 3x224x224, 1,000 classes, f32, the
# batch of 128 that train_imagenet.py uses, fit.py's SGD for config 2
GL_BATCH, GL_SHAPE, GL_CLASSES = 128, (3, 224, 224), 1000
GL_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
GL_PREFIX = "resnetv10_"
# the fixed data: GL_DATA_BATCHES batches of synthetic images, served by a
# DataLoader with GL_WORKERS worker threads; the run that must learn it
# takes GL_LEARN_STEPS steps, and its last GL_CE_STEPS steps' mean
# cross-entropy must fall below GL_CE_SHARE of its first GL_CE_STEPS'
GL_DATA_BATCHES, GL_WORKERS = 2, 2
GL_LEARN_STEPS, GL_CE_STEPS, GL_CE_SHARE = 24, 4, 0.5
# steps a timed run (eager, hybridized, hybridized, eager), and the steps
# under torch.profiler for the busy share
GL_STEPS, GL_PROFILE_STEPS = 10, 4
# steps of the hybridized path held against the eager one on the card,
# both under cuDNN's deterministic algorithms: the same kernels on the same
# inputs, replayed from a graph
GL_CAPTURE_STEPS = 6
GL_HYB_TOL = dict(atol=1e-6, rtol=0)
# steps of the shared-weight pair (the block called twice a step)
GL_SHARED_STEPS = 3
# example/gluon/word_language_model.py: its own widths, and PTB's (the
# widths BASELINE.json config 4 trains): (vocab, embed, hidden, layers,
# bptt, batch)
GL_LM_EXAMPLE = (40, 32, 64, 1, 8, 16)
GL_LM_PTB = (10000, 200, 200, 2, 32, 32)
GL_LM_LR, GL_LM_CLIP = 0.005, 5.0
GL_LM_EPOCHS, GL_LM_TOKENS = 4, 8000          # the example's own run
GL_LM_STEPS = 5                                # the timed PTB-width run
# the example's own assertions on its perplexities
GL_LM_PPL_DROP, GL_LM_PPL_VOCAB = 0.8, 0.7
# B4 and B5 held against their plain loops at the Gluon LM's shapes (the
# PTB-width shape is the serving slice's)
GL_LM_KERNEL_SHAPES = ((8, 16, 64, "float32"),)
# example/gluon/mnist.py: its accuracy must exceed this
GL_MNIST_ACC = 0.9


def gluon_resnet18(pkg, classes=GL_CLASSES, thumbnail=False):
    """gluon.model_zoo.vision.resnet18_v1 under the prefix its first
    instance gets in a fresh process, so names match across packages."""
    return pkg.gluon.model_zoo.vision.resnet18_v1(
        classes=classes, thumbnail=thumbnail, prefix=GL_PREFIX)


def gluon_xavier(pkg):
    """The initializer of BASELINE.json config 3 (fit.py's for config 2)."""
    return pkg.init.Xavier(rnd_type="gaussian", factor_type="in",
                           magnitude=2)


def gluon_weights(pkg, net, seed, sample, init=None):
    """Initialize ``net`` on the CPU from ``seed`` (deferred shapes from one
    forward of ``sample``, numpy) and return {name: numpy}: the weights the
    card's and the CPU's runs start from."""
    pkg.random.seed(seed)
    cpu = pkg.cpu()
    with cpu:
        net.initialize(init or gluon_xavier(pkg), ctx=cpu)
        net(pkg.nd.array(sample, ctx=cpu))
    return {k: v.data().asnumpy() for k, v in net.collect_params().items()}


def gluon_load(pkg, net, weights, ctx):
    """Give ``net`` ``weights`` ({name: numpy}) on ``ctx``: the port
    through ParameterDict.load_dict, mxtpu parameter by parameter."""
    params = net.collect_params()
    if hasattr(params, "load_dict"):
        params.load_dict(weights, ctx=ctx)
        return net
    for k, v in weights.items():
        params[k].set_data(pkg.nd.array(v, ctx=ctx))
    return net


def gluon_values(net):
    """{name: numpy} of every parameter, moving statistics included."""
    return {k: v.data().asnumpy() for k, v in net.collect_params().items()}


def gluon_grads(net):
    """{name: numpy} of every trained parameter's gradient."""
    return {k: v.grad().asnumpy() for k, v in net.collect_params().items()
            if v.grad_req != "null"}


def gluon_images(seed, n, shape=GL_SHAPE, classes=GL_CLASSES):
    """Synthetic images in [-1, 1) and integer labels (float32) from
    ``seed``."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1.0, 1.0, (n,) + tuple(shape)).astype(np.float32)
    y = rng.randint(0, classes, n).astype(np.float32)
    return x, y


class GluonRun:
    """example/gluon/mnist.py:56-60's loop over a gluon DataLoader of an
    ArrayDataset, on ``ctx``: ``with autograd.record(): loss =
    loss_fn(net(x), y)``, ``loss.backward()``, ``trainer.step(batch)``.
    ``steps(n)`` runs n steps (a new pass over the data when one ends),
    keeping each step's mean loss on the device; ``clock`` gathers the host
    seconds of each phase."""

    def __init__(self, pkg, net, data, ctx, batch, hybridize,
                 opt=GL_OPT, workers=0, shuffle=False):
        self.pkg, self.net, self.ctx, self.batch = pkg, net, ctx, batch
        if hybridize:
            net.hybridize()
        self.trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                         dict(opt))
        self.loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        if not isinstance(data, pkg.gluon.data.Dataset):
            data = pkg.gluon.data.ArrayDataset(*data)
        self.loader = pkg.gluon.data.DataLoader(
            data, batch_size=batch, shuffle=shuffle, last_batch="discard",
            num_workers=workers)
        self.losses = []
        self.clock = {}
        self._it = None
        self._last = None

    def _next(self):
        with self.ctx:
            for _ in range(2):
                if self._it is None:
                    self._it = iter(self.loader)
                try:
                    return next(self._it)
                except StopIteration:
                    self._it = None
        raise RuntimeError("the DataLoader gave no batch")

    def steps(self, n, held=False):
        """``n`` steps; ``held``: on the batch drawn last, again."""
        pkg, clock = self.pkg, self.clock
        for _ in range(n):
            t0 = time.perf_counter()
            x, y = self._last if held else self._next()
            self._last = (x, y)
            t1 = time.perf_counter()
            with pkg.autograd.record():
                loss = self.loss_fn(self.net(x), y)
            loss.backward()
            t2 = time.perf_counter()
            self.trainer.step(self.batch)
            t3 = time.perf_counter()
            self.losses.append(loss.mean())
            for phase, dt in (("data loader", t1 - t0),
                              ("forward/backward", t2 - t1),
                              ("trainer.step", t3 - t2)):
                clock[phase] = clock.get(phase, 0.0) + dt
        return self

    def loss_values(self):
        return [float(v.asscalar()) for v in self.losses]


def gluon_resnet_run(pkg, weights, data, ctx, batch, hybridize, steps,
                     classes=GL_CLASSES, thumbnail=False, workers=0):
    """ResNet-18 v1 from ``weights`` trained ``steps`` steps on ``ctx``
    (the port's or mxtpu's); returns the GluonRun."""
    net = gluon_load(pkg, gluon_resnet18(pkg, classes, thumbnail), weights,
                     ctx)
    return GluonRun(pkg, net, data, ctx, batch, hybridize,
                    workers=workers).steps(steps)


def hybrid_report(net, label, steps):
    """Fail unless the hybridized ``net`` ran ``steps`` calls as one program
    (one signature and train flag): one compile, one capture at its second
    call, a replay in every later one, no uncaptured call and no
    fallback. Returns the counts
    as text."""
    stats = net.cache_stats()
    want = {"programs": 1, "compiles": 1, "hits": steps - 1, "captures": 1,
            "replays": steps - 1, "uncaptured": 0, "fallbacks": 0}
    if stats != want:
        fail("%s: hybridized counts %s, want %s" % (label, stats, want))
    prog = net.programs()[0]
    return ("%d calls: 1 compile, 1 capture, %d replays; graph pool %.1f MB"
            % (steps, stats["replays"], prog.pool_bytes / 2 ** 20))


def gluon_first_steps(mt, seed):
    """ResNet-18's first steps at RN_CHECK_BATCH, TF32 off, on the card
    (eager) against the CPU: after 1 step each weight within RN_STEP_SHARE
    of its parameter's step (plus RN_ATOL), the moving statistics within
    RN_AUX_TOL of a layer's largest; after FIT_STEPS steps the weights' and
    the moving statistics' distance from the CPU's, as a share of their
    move, and each step's loss, within RN_SPREAD times what the CPU itself
    gives from weights one ulp apart (as imagenet_first_steps)."""
    gpu, cpu = mt.gpu(0), mt.cpu()
    data = gluon_images(seed, RN_CHECK_BATCH * FIT_STEPS)
    w0 = gluon_weights(mt, gluon_resnet18(mt), seed, data[0][:1])
    where = "Gluon ResNet-18 first steps at batch %d, card vs CPU" \
        % RN_CHECK_BATCH
    aux = [k for k in w0 if k.endswith(("running_mean", "running_var"))]

    def split(vals):
        return ({k: v for k, v in vals.items() if k not in aux},
                {k: vals[k] for k in aux})

    def run(ctx, weights):
        """The weights, moving statistics and losses after FIT_STEPS
        steps, and the weights and statistics after the first."""
        r = gluon_resnet_run(mt, weights, data, ctx, RN_CHECK_BATCH, False,
                             1)
        first = split(gluon_values(r.net))
        r.steps(FIT_STEPS - 1)
        return split(gluon_values(r.net)) + (r.loss_values(),) + first

    card = run(gpu, w0)
    host = run(cpu, w0)
    (g_w, g_aux), (c_w, c_aux) = card[3:], host[3:]
    args0 = {k: v for k, v in w0.items() if k not in aux}
    w = step_share_check(where + ", 1 step", g_w, c_w, args0, RN_STEP_SHARE,
                         RN_ATOL)
    aux_err = max(float(np.abs(g_aux[k] - c_aux[k]).max()
                        / np.abs(c_aux[k]).max()) for k in aux)
    if aux_err > RN_AUX_TOL:
        fail("%s: moving statistics after 1 step differ by %.3g of a layer's "
             "largest (limit %g)" % (where, aux_err, RN_AUX_TOL))
    ulp = run(cpu, ulp_apart(w0, seed))
    readings = []
    for i, (what, start) in enumerate((("weights", args0), (
            "moving statistics", {k: w0[k] for k in aux}))):
        got = norm_share(card[i], host[i], start)
        spread = norm_share(ulp[i], host[i], start)
        if not got <= RN_SPREAD * spread + RN_AUX_TOL:
            fail("%s: %s after %d steps apart by %.3g of their move; the CPU "
                 "from weights one ulp apart: %.3g (limit %g times it)"
                 % (where, what, FIT_STEPS, got, spread, RN_SPREAD))
        readings.append("%s %.3g (the CPU one ulp apart: %.3g)"
                        % (what, got, spread))
    for k, (g, c, u) in enumerate(zip(card[2], host[2], ulp[2])):
        if not abs(g - c) <= RN_SPREAD * abs(u - c) + RN_AUX_TOL * c:
            fail("%s: the loss of step %d is %.6f on the card, %.6f on the "
                 "CPU (%.6f from weights one ulp apart)"
                 % (where, k + 1, g, c, u))
    print("%s: 1 step: the weights use %.3g of their limit (%.2f of their "
          "parameter's step + %g), moving statistics within %.3g of a "
          "layer's largest (limit %g); %d steps: apart by a share of their "
          "move: %s (limit %g times the CPU's own); losses card %s, CPU %s, "
          "one ulp apart %s"
          % (where, w, RN_STEP_SHARE, RN_ATOL, aux_err, RN_AUX_TOL,
             FIT_STEPS, "; ".join(readings), RN_SPREAD,
             ", ".join("%.5f" % x for x in card[2]),
             ", ".join("%.5f" % x for x in host[2]),
             ", ".join("%.5f" % x for x in ulp[2])), flush=True)
    return w0


def gluon_hybrid_check(mt, w0, seed):
    """GL_CAPTURE_STEPS hybridized steps against eager ones on the card at
    RN_CHECK_BATCH, both with cuDNN's deterministic algorithms: weights and
    moving statistics within GL_HYB_TOL, and the hybridized block's counts
    (hybrid_report)."""
    import torch
    gpu = mt.gpu(0)
    data = gluon_images(seed + 1, RN_CHECK_BATCH * GL_CAPTURE_STEPS)
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {h: gluon_resnet_run(mt, w0, data, gpu, RN_CHECK_BATCH, h,
                                    GL_CAPTURE_STEPS) for h in (False, True)}
    finally:
        torch.backends.cudnn.deterministic = old
    text = hybrid_report(runs[True].net, "Gluon ResNet-18 capture check",
                         GL_CAPTURE_STEPS)
    got, want = gluon_values(runs[True].net), gluon_values(runs[False].net)
    names = sorted(want)
    check_close("Gluon ResNet-18: %d hybridized steps vs eager ones on the "
                "card (deterministic cuDNN)" % GL_CAPTURE_STEPS,
                [torch.from_numpy(got[k]) for k in names],
                [torch.from_numpy(want[k]) for k in names], GL_HYB_TOL)
    print("Gluon ResNet-18 hybridized vs eager at batch %d (deterministic "
          "cuDNN): %s; max |diff| over weights and moving statistics %.3g "
          "(tolerance %s); losses hybridized %s, eager %s"
          % (RN_CHECK_BATCH, text, max(float(np.abs(got[k] - want[k]).max())
                                       for k in names), GL_HYB_TOL,
             ", ".join("%.5f" % v for v in runs[True].loss_values()),
             ", ".join("%.5f" % v for v in runs[False].loss_values())),
          flush=True)


def gluon_shared_call_check(mt, w0, seed):
    """One hybridized ResNet-18 called twice under one record() a step, on
    two batches of RN_CHECK_BATCH images with one loss over both (a
    shared-weight pair, as a siamese net or a triplet loss calls it),
    GL_SHARED_STEPS steps against the eager block, both under cuDNN's
    deterministic algorithms: losses, weights and moving statistics within
    GL_HYB_TOL. The first step's second call captures; from the second
    step on, a step's first call replays and its second finds the graphs
    busy (their activations await the first call's backward) and
    evaluates the traced graph uncaptured."""
    import torch
    gpu = mt.gpu(0)
    x, y = gluon_images(seed + 4, 2 * RN_CHECK_BATCH)
    halves = [(mt.nd.array(x[i::2], ctx=gpu), mt.nd.array(y[i::2], ctx=gpu))
              for i in (0, 1)]
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for hyb in (False, True):
            net = gluon_load(mt, gluon_resnet18(mt), w0, gpu)
            if hyb:
                net.hybridize()
            trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                                       dict(GL_OPT))
            loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
            losses = []
            for _ in range(GL_SHARED_STEPS):
                with mt.autograd.record():
                    loss = sum(loss_fn(net(a), b).mean() for a, b in halves)
                loss.backward()
                trainer.step(len(halves))
                losses.append(float(loss.asscalar()))
            runs[hyb] = (net, losses)
    finally:
        torch.backends.cudnn.deterministic = old
    net = runs[True][0]
    stats = net.cache_stats()
    want = dict(programs=1, compiles=1, hits=2 * GL_SHARED_STEPS - 1,
                captures=1, replays=GL_SHARED_STEPS,
                uncaptured=GL_SHARED_STEPS - 1, fallbacks=0)
    if stats != want:
        fail("Gluon ResNet-18 called twice a step: hybridized counts %s, "
             "want %s" % (stats, want))
    got, ref = gluon_values(net), gluon_values(runs[False][0])
    names = sorted(ref)
    check_close("Gluon ResNet-18 called twice a step: %d hybridized steps "
                "vs eager ones on the card (deterministic cuDNN)"
                % GL_SHARED_STEPS,
                [torch.tensor(runs[True][1])]
                + [torch.from_numpy(got[k]) for k in names],
                [torch.tensor(runs[False][1])]
                + [torch.from_numpy(ref[k]) for k in names], GL_HYB_TOL)
    print("Gluon ResNet-18 called twice under one record() a step, batch "
          "%d a call: %d steps, counts %s; max |diff| over losses, weights "
          "and moving statistics %.3g (tolerance %s); losses hybridized %s, "
          "eager %s"
          % (RN_CHECK_BATCH, GL_SHARED_STEPS, stats,
             max([float(np.abs(got[k] - ref[k]).max()) for k in names]
                 + [abs(a - b) for a, b in zip(runs[True][1],
                                               runs[False][1])]),
             GL_HYB_TOL, ", ".join("%.5f" % v for v in runs[True][1]),
             ", ".join("%.5f" % v for v in runs[False][1])), flush=True)


def gluon_step_bound(mt, run):
    """One eager step of ``run`` under FlopCounterMode: (conv FLOPs, matmul
    FLOPs, bytes a step must move: the batch, every weight, momentum and
    moving statistic read once and written once, the logits written)."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        run.steps(1)
    by_op = counter.get_flop_counts().get("Global", {})
    conv = sum(v for k, v in by_op.items() if "convolution" in str(k))
    matmul = counter.get_total_flops() - conv
    n_param = n_aux = 0
    for p in run.net.collect_params().values():
        if p.grad_req == "null":
            n_aux += p.data().size
        else:
            n_param += p.data().size
    nbytes = 4 * (GL_BATCH * (int(np.prod(GL_SHAPE)) + 1)
                  + 2 * (2 * n_param + n_aux) + GL_BATCH * GL_CLASSES)
    return (conv, matmul), nbytes


def gluon_full_width(mt, w0, seed, card, tf32, setting, bound):
    """ResNet-18 v1 at 224, batch 128, on gpu(0) under one TF32 setting,
    eager and hybridized: under torch's default TF32 each path first
    trains GL_LEARN_STEPS steps and must learn the fixed data; then both
    are timed in turns (eager, hybridized, hybridized, eager; GL_STEPS
    steps each): ms a step, images/s, host ms by phase, the card's busy
    share and launches a step, the share of the step's bound (FLOPs by
    FlopCounterMode, counted once in ``bound``). Returns ({path: ms},
    bound)."""
    import torch
    gpu = mt.gpu(0)
    data = gluon_images(seed + 2, GL_BATCH * GL_DATA_BATCHES)
    runs, out = {}, {}
    with tf32_mode(tf32):
        for path in ("eager", "hybridized"):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            runs[path] = run = gluon_resnet_run(
                mt, w0, data, gpu, GL_BATCH, path == "hybridized",
                GL_LEARN_STEPS if tf32 else 2, workers=GL_WORKERS)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            ce = run.loss_values()
            if not all(np.isfinite(ce)):
                fail("Gluon ResNet-18 %s: losses %s" % (path, ce))
            first = float(np.mean(ce[:GL_CE_STEPS]))
            last = float(np.mean(ce[-GL_CE_STEPS:]))
            if tf32 and not last < GL_CE_SHARE * first:
                fail("Gluon ResNet-18 %s: the fixed data's cross-entropy "
                     "went from %.4f to %.4f over %d steps (limit %.2f of the "
                     "first)" % (path, first, last, len(ce), GL_CE_SHARE))
            text = "eager" if path == "eager" else hybrid_report(
                run.net, "Gluon ResNet-18 " + setting, len(ce))
            print("Gluon ResNet-18 %s, %s: %d steps at batch %d in %.2f s; "
                  "cross-entropy of the first %d steps %.4f, of the last %d "
                  "%.4f (limit %.2f of the first); %s; peak memory %.2f GB "
                  "| %s" % (path, setting, len(ce), GL_BATCH, secs,
                            GL_CE_STEPS, first, GL_CE_STEPS, last,
                            GL_CE_SHARE, text,
                            torch.cuda.max_memory_allocated() / 1e9, card),
                  flush=True)
            run.clock.clear()
        if bound is None:
            bound = gluon_step_bound(mt, runs["eager"])
            (conv, matmul), nbytes = bound
            print("Gluon ResNet-18 step at batch %d: %.4g conv FLOPs + %.4g "
                  "matmul FLOPs (FlopCounterMode over one eager step; %.3g "
                  "GMAC an image forward), %.4g bytes to move at least; "
                  "bound %.3f ms with cuDNN TF32, %.3f ms in float32 | %s"
                  % (GL_BATCH, conv, matmul, (conv + matmul) / 6 / GL_BATCH
                     / 1e9, nbytes, bound_ms(*bound, True)[0],
                     bound_ms(*bound, False)[0], card), flush=True)
            runs["eager"].clock.clear()
        ms = {k: [] for k in runs}
        for path in ("eager", "hybridized", "hybridized", "eager"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[path].steps(GL_STEPS)
            torch.cuda.synchronize()
            ms[path].append((time.perf_counter() - t0) / GL_STEPS * 1e3)
        limit, by = bound_ms(*bound, tf32)
        for path, run in runs.items():
            step = out[path] = float(np.mean(ms[path]))
            host = "; ".join("%s %.3f" % (p, v / (2 * GL_STEPS) * 1e3)
                             for p, v in run.clock.items())
            busy, top = device_time(lambda: run.steps(GL_PROFILE_STEPS), 1,
                                    per=GL_PROFILE_STEPS)
            print("Gluon ResNet-18 %s step, %s (cuDNN TF32 %s, matmul TF32 "
                  "off): %.3f ms (%s), %.1f images/s; bound %.3f ms (%s), "
                  "%.1f%% of it; host ms a step by phase: %s; %s; per step: "
                  "%s | %s"
                  % (path, setting, "on" if tf32 else "off", step,
                     ", ".join("%.3f" % v for v in ms[path]),
                     GL_BATCH / step * 1e3, limit, by, 100 * limit / step,
                     host, busy_of(busy, step), top, card), flush=True)
        print("Gluon ResNet-18 step, %s: eager %.3f ms, hybridized %.3f ms "
              "(%.2fx) | %s" % (setting, out["eager"], out["hybridized"],
                                out["eager"] / out["hybridized"], card))
    return out, bound


def markov_corpus(n_tokens, vocab, rng, support=None):
    """example/gluon/word_language_model.py's corpus (a copy: the example
    imports mxtpu): each token's successor drawn from its state's
    heavy-tailed distribution over the vocabulary, or, with ``support``,
    over that many successors a state (the same kind of chain at PTB's
    vocabulary, whose full transition matrix would take 800 MB)."""
    if support is None:
        trans = rng.dirichlet(np.full(vocab, 0.12), size=vocab)
        succ = np.broadcast_to(np.arange(vocab), (vocab, vocab))
    else:
        succ = rng.randint(0, vocab, (vocab, support))
        trans = rng.dirichlet(np.full(support, 0.12), size=vocab)
    toks = np.zeros(n_tokens, np.int64)
    for i in range(1, n_tokens):
        toks[i] = succ[toks[i - 1]][rng.choice(trans.shape[1],
                                               p=trans[toks[i - 1]])]
    return toks


def lm_batchify(toks, batch):
    nb = len(toks) // batch
    return toks[:nb * batch].reshape(batch, nb).T   # (nb, batch)


def gluon_rnn_model(pkg, vocab, embed, hidden, layers, mode="lstm"):
    """The example's RNNModel (an eager gluon.Block: embedding, a fused
    LSTM or GRU layer, a Dense decoder), with the layer count and mode as
    arguments, under the prefix its first instance gets."""
    gluon = pkg.gluon

    class RNNModel(gluon.Block):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.embedding = gluon.nn.Embedding(vocab, embed)
                layer = gluon.rnn.LSTM if mode == "lstm" else gluon.rnn.GRU
                self.lstm = layer(hidden, num_layers=layers)
                self.decoder = gluon.nn.Dense(vocab, flatten=False)

        def forward(self, x):
            return self.decoder(self.lstm(self.embedding(x)))

    return RNNModel(prefix="rnnmodel0_")


def gluon_lm_train(pkg, model, data, ctx, bptt, batch, steps=None,
                   epochs=None, clock=None):
    """The example's loop: Adam (GL_LM_LR, clip_gradient GL_LM_CLIP),
    SoftmaxCrossEntropyLoss over ``logits.reshape((-3, 0))``, ``bptt``
    tokens a step over ``data`` (nb, batch). Runs ``epochs`` passes, or
    ``steps`` steps. Returns (each pass's perplexity, each step's mean
    loss); the sums stay on the device until the end."""
    trainer = pkg.gluon.Trainer(model.collect_params(), "adam",
                                {"learning_rate": GL_LM_LR,
                                 "clip_gradient": GL_LM_CLIP})
    ce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    starts = list(range(0, data.shape[0] - bptt - 1, bptt))
    plan = [starts] * epochs if epochs else [
        [starts[i % len(starts)] for i in range(steps)]]
    sums, means = [], []
    for pass_starts in plan:
        total = []
        for i in pass_starts:
            x = pkg.nd.array(data[i:i + bptt].astype("f"), ctx=ctx)
            t = pkg.nd.array(data[i + 1:i + bptt + 1].astype("f"), ctx=ctx)
            t0 = time.perf_counter()
            with pkg.autograd.record():
                logits = model(x)
                loss = ce(logits.reshape((-3, 0)), t.reshape((-1,)))
            loss.backward()
            t1 = time.perf_counter()
            trainer.step(bptt * batch)
            if clock is not None:
                clock["forward/backward"] = clock.get(
                    "forward/backward", 0.0) + t1 - t0
                clock["trainer.step"] = clock.get(
                    "trainer.step", 0.0) + time.perf_counter() - t1
            total.append(loss.sum())
            means.append(loss.mean())
        sums.append((total, len(pass_starts) * bptt * batch))
    ppl = [float(np.exp(sum(float(v.asscalar()) for v in total) / n))
           for total, n in sums]
    return ppl, [float(v.asscalar()) for v in means]


def gluon_lm_phase(mt, rnn_scan, seed, card):
    """The Gluon word LM on gpu(0): the example's own run (its widths, 4
    epochs, its perplexity assertions), lstm_scan launched once a layer a
    forward; at PTB's widths the first FIT_STEPS steps against the CPU
    (weights and losses within RN_SPREAD times the CPU's own spread from
    weights one ulp apart: Adam's float32 steps jump where a rounding flips
    a mask), then GL_LM_STEPS steps timed (ms a step, tokens/s); the GRU
    variant, gru_scan once a layer a forward. Returns {kernel: launches}."""
    import torch
    gpu, cpu = mt.gpu(0), mt.cpu()
    launches = {}

    def lm(widths, mode, tokens):
        vocab, embed, hidden, layers, bptt, batch = widths
        rng = np.random.RandomState(seed)
        toks = markov_corpus(tokens, vocab, rng,
                             None if vocab <= 1000 else 16)
        model = gluon_rnn_model(mt, vocab, embed, hidden, layers, mode)
        w0 = gluon_weights(mt, model, seed, np.zeros((1, 1), np.float32),
                           init=mt.init.Xavier())
        return lm_batchify(toks, batch), w0

    def counted(kernel, forwards, layers, fn):
        rnn_scan.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = rnn_scan.LAUNCHES[kernel]
        if got != forwards * layers:
            fail("Gluon LM: %s launched %d times in %d forwards of %d "
                 "layer(s)" % (kernel, got, forwards, layers))
        launches[kernel] = launches.get(kernel, 0) + got
        return out

    # the example's own run
    widths = GL_LM_EXAMPLE
    data, w0 = lm(widths, "lstm", GL_LM_TOKENS)
    model = gluon_load(mt, gluon_rnn_model(mt, *widths[:4]), w0, gpu)
    starts = len(range(0, data.shape[0] - widths[4] - 1, widths[4]))
    t0 = time.perf_counter()
    ppls, _ = counted("lstm_scan", GL_LM_EPOCHS * starts, widths[3],
                      lambda: gluon_lm_train(mt, model, data, gpu,
                                             widths[4], widths[5],
                                             epochs=GL_LM_EPOCHS))
    secs = time.perf_counter() - t0
    if not (ppls[-1] < ppls[0] * GL_LM_PPL_DROP
            and ppls[-1] < widths[0] * GL_LM_PPL_VOCAB):
        fail("Gluon word LM (the example's run): perplexity by epoch %s"
             % ppls)
    print("Gluon word LM, the example's run on gpu(0) (vocabulary %d, embed "
          "%d, hidden %d, %d layer, bptt %d, batch %d, %d epochs of %d "
          "steps): perplexity by epoch %s (the example asserts < %.1f of the "
          "first and < %.1f); lstm_scan launched once a forward; %.2f s"
          % (widths[0], widths[1], widths[2], widths[3], widths[4],
             widths[5], GL_LM_EPOCHS, starts, ", ".join(
                 "%.2f" % p for p in ppls), GL_LM_PPL_DROP,
             widths[0] * GL_LM_PPL_VOCAB, secs), flush=True)

    # PTB's widths: first steps against the CPU, then timed; the GRU variant
    widths = GL_LM_PTB
    vocab, embed, hidden, layers, bptt, batch = widths
    tokens = batch * (bptt * GL_LM_STEPS + 2)
    for mode, kernel in (("lstm", "lstm_scan"), ("gru", "gru_scan")):
        data, w0 = lm(widths, mode, tokens)
        where = "Gluon word LM (%s) at PTB's widths, first %d steps, card " \
            "vs CPU" % (mode, FIT_STEPS)

        def first(ctx, weights):
            model = gluon_load(mt, gluon_rnn_model(mt, vocab, embed, hidden,
                                                   layers, mode),
                               weights, ctx)
            _, losses = gluon_lm_train(mt, model, data, ctx, bptt, batch,
                                       steps=FIT_STEPS)
            return gluon_values(model), losses

        g = counted(kernel, FIT_STEPS, layers, lambda: first(gpu, w0))
        c = first(cpu, w0)
        u = first(cpu, ulp_apart(w0, seed))
        got, spread = norm_share(g[0], c[0], w0), norm_share(u[0], c[0], w0)
        if not got <= RN_SPREAD * spread + RN_AUX_TOL:
            fail("%s: weights apart by %.3g of their move; the CPU from "
                 "weights one ulp apart: %.3g" % (where, got, spread))
        for k, (a, b, d) in enumerate(zip(g[1], c[1], u[1])):
            if not abs(a - b) <= RN_SPREAD * abs(d - b) + RN_AUX_TOL * b:
                fail("%s: the loss of step %d is %.6f on the card, %.6f on "
                     "the CPU (%.6f from weights one ulp apart)"
                     % (where, k + 1, a, b, d))
        print("%s: weights apart by %.3g of their move (the CPU one ulp "
              "apart: %.3g, limit %g times it); losses card %s, CPU %s, one "
              "ulp apart %s" % (where, got, spread, RN_SPREAD,
                                ", ".join("%.5f" % v for v in g[1]),
                                ", ".join("%.5f" % v for v in c[1]),
                                ", ".join("%.5f" % v for v in u[1])),
              flush=True)
        model = gluon_load(mt, gluon_rnn_model(mt, vocab, embed, hidden,
                                               layers, mode), w0, gpu)
        gluon_lm_train(mt, model, data, gpu, bptt, batch, steps=2)
        clock = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ppl, _ = counted(kernel, GL_LM_STEPS, layers,
                         lambda: gluon_lm_train(mt, model, data, gpu, bptt,
                                                batch, steps=GL_LM_STEPS,
                                                clock=clock))
        step = (time.perf_counter() - t0) / GL_LM_STEPS * 1e3
        busy, top = device_time(lambda: gluon_lm_train(
            mt, model, data, gpu, bptt, batch, steps=2), 1, per=2)
        print("Gluon word LM (%s) at PTB's widths (vocabulary %d, embed %d, "
              "hidden %d, %d layers, bptt %d, batch %d): %.3f ms a step, "
              "%.0f tokens/s over %d steps (perplexity %.1f); host ms a step "
              "by phase: %s; %s; per step: %s; %s launched once a layer a "
              "forward | %s"
              % (mode, vocab, embed, hidden, layers, bptt, batch, step,
                 bptt * batch / step * 1e3, GL_LM_STEPS, ppl[0], "; ".join(
                     "%s %.3f" % (p, v / GL_LM_STEPS * 1e3)
                     for p, v in clock.items()), busy_of(busy, step), top,
                 kernel, card), flush=True)
    return launches


def synthetic_mnist(n=512, seed=0):
    """example/gluon/mnist.py's synthetic digits (a copy: the example
    imports mxtpu)."""
    r = np.random.RandomState(seed)
    y = (r.rand(n) * 10).astype("f")
    x = r.rand(n, 1, 28, 28).astype("f") * 0.1
    for i in range(n):  # a class-dependent blob, so the task is learnable
        c = int(y[i])
        x[i, 0, 2 * c:2 * c + 6, 4:24] += 0.8
    return x, y


def gluon_mnist(pkg, ctx, epochs=3, batch_size=64, lr=0.1):
    """example/gluon/mnist.py's main on ``ctx`` (its seed, NDArrayIter with
    shuffle, the hybridized 3-layer MLP, SGD with momentum, Accuracy). The
    port's NDArrayIter serves host batches, so they are moved to ``ctx``.
    Returns (the last epoch's accuracy, the net)."""
    np.random.seed(0)
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="hybridsequential0_")
    net.add(nn.Dense(128, activation="relu"),
            nn.Dense(64, activation="relu"),
            nn.Dense(10))
    net.initialize(pkg.init.Xavier(), ctx=ctx)
    net.hybridize()
    x, y = synthetic_mnist()
    train = pkg.io.NDArrayIter(x, y, batch_size, shuffle=True)
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": lr, "momentum": 0.9})
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    metric = pkg.metric.Accuracy()
    for _ in range(epochs):
        train.reset()
        metric.reset()
        for batch in train:
            data = batch.data[0].as_in_context(ctx)
            label = batch.label[0].as_in_context(ctx)
            with pkg.autograd.record():
                out = net(data.reshape((data.shape[0], -1)))
                loss = loss_fn(out, label)
            loss.backward()
            trainer.step(data.shape[0])
            metric.update([label], [out])
    return metric.get()[1], net


def gluon_phase(mt, rnn_scan, seed, card):
    """The Gluon slice on gpu(0): ResNet-18 v1's first steps against the
    CPU, hybridized against eager (also called twice a step), the
    full-width run under TF32 on and off; the Gluon word LM (B4; B5 in the
    GRU variant); the hybridized MLP of example/gluon/mnist.py. Returns ({(path, setting): ms a step},
    {kernel: launches in the Gluon LM})."""
    import gc
    import torch
    clock = [("start", time.perf_counter())]
    w0 = gluon_first_steps(mt, seed)
    clock.append(("first steps", time.perf_counter()))
    gluon_hybrid_check(mt, w0, seed)
    clock.append(("hybridized vs eager", time.perf_counter()))
    gluon_shared_call_check(mt, w0, seed)
    clock.append(("called twice a step", time.perf_counter()))
    full = gluon_weights(mt, gluon_resnet18(mt), seed,
                         np.zeros((1,) + GL_SHAPE, np.float32))
    out, bound = {}, None
    for tf32, setting in ((True, "TF32 on"), (False, "TF32 off")):
        times, bound = gluon_full_width(mt, full, seed, card, tf32, setting,
                                        bound)
        for path, ms in times.items():
            out[path, setting] = ms
        gc.collect()
        torch.cuda.empty_cache()
        clock.append(("full width, " + setting, time.perf_counter()))
    launches = gluon_lm_phase(mt, rnn_scan, seed, card)
    clock.append(("word LM", time.perf_counter()))
    acc, net = gluon_mnist(mt, mt.gpu(0))
    if not acc > GL_MNIST_ACC:
        fail("example/gluon/mnist.py on gpu(0): accuracy %.4f (the example "
             "asserts > %.1f)" % (acc, GL_MNIST_ACC))
    print("example/gluon/mnist.py hybridized on gpu(0): last epoch's "
          "accuracy %.4f (> %.1f); %s"
          % (acc, GL_MNIST_ACC, net.cache_stats()), flush=True)
    clock.append(("MLP", time.perf_counter()))
    print("Gluon phase: %.1f s (%s)" % (
        clock[-1][1] - clock[0][1], ", ".join(
            "%s %.1f" % (name, t - clock[i][1])
            for i, (name, t) in enumerate(clock[1:]))))
    return out, launches


# ---------------------------------------------------------------------------
# The CIFAR records slice: example/image-classification/train_cifar10.py
# --synthetic N, its JPEG records read by ImageRecordIter's decode pool and
# trained through common/fit.py's Module.fit call. The example imports
# mxtpu, so its arguments, record writer, iterators and fit call are
# mirrored here for either package.
# ---------------------------------------------------------------------------

# The run at the example's own widths: ResNet-110 at 3x28x28, 10 classes,
# batch 128, f32; --synthetic 5120 (40 steps an epoch; 1,024 validation
# records, as ensure_synthetic makes them; at 4,480 the eager fit's
# cross-entropy fell only to 0.508 of its start in one H100 run). Under
# torch's default TF32 each path trains CF_EPOCHS epochs and must learn
# the data: the mean cross-entropy of its last 4 steps below CF_CE_SHARE
# of its first 4's; with TF32 off each trains one epoch for its times.
# The iterator alone reads CF_IO_EPOCHS epochs.
CF_RECORDS, CF_EPOCHS, CF_IO_EPOCHS = 5120, 3, 1
CF_CE_SHARE = 0.5
CF_LAYERS = 110
# timed turns of CF_TIMED_STEPS steps (eager, captured, the captured step
# on a held batch twice, captured, eager); the busy share from
# torch.profiler over CF_PROFILE_STEPS steps
CF_TIMED_STEPS, CF_PROFILE_STEPS = 3, 2
# the padded-batch check: records for 3 steps at batch 128, the last one
# padded by 40 rows
CF_PAD_RECORDS = 3 * 128 - 40
# After a fit, the validation outputs (score()'s forward) against an
# eager Module bound for inference with the weights and moving statistics
# read from the fitted one, both under cuDNN's deterministic algorithms:
# the same kernels on the same inputs, so within CF_EVAL_TOL of the
# softmax.
CF_EVAL_TOL = 1e-5
# The decoders set the captured step's pace when the step fed by them takes
# longer than CF_PACE times the same step repeated on one batch already on
# the card.
CF_PACE = 1.05


def cifar_args(**overrides):
    """train_cifar10.py's arguments as its parser gives them with no
    command line: fit.py's and data.py's defaults, the augmentations of
    set_data_aug_level(parser, 2), then the script's own set_defaults;
    ``overrides`` replace any of them. An argparse.Namespace."""
    args = dict(
        # fit.add_fit_args
        network="resnet", num_layers=CF_LAYERS, engine="module",
        kv_store="device", num_epochs=300, lr=0.05, lr_factor=0.1,
        lr_step_epochs="200,250", initializer="default", optimizer="sgd",
        mom=0.9, wd=0.0001, batch_size=128, disp_batches=20,
        model_prefix=None, monitor=0, load_epoch=None, top_k=0, loss="",
        test_io=0, dtype="float32", gc_type="none", gc_threshold=0.5,
        # data.add_data_args
        data_train=os.path.join("data", "cifar10_train.rec"),
        data_val=os.path.join("data", "cifar10_val.rec"),
        rgb_mean="123.68,116.779,103.939", pad_size=4, image_shape="3,28,28",
        num_classes=10, num_examples=50000, data_nthreads=4, benchmark=0,
        # data.add_data_aug_args at level 2
        random_crop=1, random_mirror=1, max_random_h=36, max_random_s=50,
        max_random_l=50, max_random_aspect_ratio=0,
        max_random_rotate_angle=0, max_random_shear_ratio=0,
        max_random_scale=1, min_random_scale=1,
        # train_cifar10.py
        synthetic=0)
    args.update(overrides)
    return argparse.Namespace(**args)


def make_synthetic_recfile(pkg, path, num_images, image_hw, num_classes,
                           seed=0):
    """common/data.py's make_synthetic_recfile in either package: JPEG
    records (quality 95) whose brightness follows the label."""
    rng = np.random.RandomState(seed)
    writer = pkg.recordio.MXRecordIO(path, "w")
    try:
        for i in range(num_images):
            label = i % num_classes
            base = 40 + (175 * label) // max(1, num_classes - 1)
            img = rng.randint(-35, 36, (image_hw, image_hw, 3)) + base
            img = np.clip(img, 0, 255).astype(np.uint8)
            header = pkg.recordio.IRHeader(0, float(label), i, 0)
            writer.write(pkg.recordio.pack_img(header, img, quality=95))
    finally:
        writer.close()
    return path


def cifar_synthetic(pkg, args, root):
    """train_cifar10.py's ensure_synthetic, writing under ``root`` instead
    of the working directory's data/: (train .rec, validation .rec)."""
    hw = int(args.image_shape.split(",")[1])
    train = os.path.join(root, "cifar10_synth_train.rec")
    val = os.path.join(root, "cifar10_synth_val.rec")
    make_synthetic_recfile(pkg, train, args.synthetic, hw, args.num_classes,
                           seed=0)
    make_synthetic_recfile(pkg, val, max(args.batch_size,
                                         args.synthetic // 5), hw,
                           args.num_classes, seed=1)
    return train, val


def get_rec_iter(pkg, args, kv=None):
    """common/data.py's get_rec_iter (its record branch) in either package:
    the (train, validation) ImageRecordIters, sharded by the kvstore's
    rank."""
    image_shape = tuple(int(x) for x in args.image_shape.split(","))
    rank, nworker = (kv.rank, kv.num_workers) if kv else (0, 1)
    rgb_mean = [float(x) for x in args.rgb_mean.split(",")]
    train = pkg.io.ImageRecordIter(
        path_imgrec=args.data_train,
        data_shape=image_shape,
        batch_size=args.batch_size,
        mean_r=rgb_mean[0], mean_g=rgb_mean[1], mean_b=rgb_mean[2],
        rand_crop=args.random_crop,
        rand_mirror=args.random_mirror,
        pad=args.pad_size, fill_value=127,
        max_random_scale=args.max_random_scale,
        min_random_scale=args.min_random_scale,
        max_aspect_ratio=args.max_random_aspect_ratio,
        random_h=args.max_random_h, random_s=args.max_random_s,
        random_l=args.max_random_l,
        max_rotate_angle=args.max_random_rotate_angle,
        max_shear_ratio=args.max_random_shear_ratio,
        preprocess_threads=args.data_nthreads,
        shuffle=True, num_parts=nworker, part_index=rank)
    if not args.data_val:
        return train, None
    val = pkg.io.ImageRecordIter(
        path_imgrec=args.data_val,
        data_shape=image_shape,
        batch_size=args.batch_size,
        mean_r=rgb_mean[0], mean_g=rgb_mean[1], mean_b=rgb_mean[2],
        rand_crop=False, rand_mirror=False,
        preprocess_threads=args.data_nthreads,
        num_parts=nworker, part_index=rank)
    return train, val


def run_test_io(args, train):
    """fit.py's _run_test_io: one epoch of ``train`` with every batch's
    data waited for, Speedometer-style lines every disp_batches batches.
    Returns (batches, seconds)."""
    t0 = tic = time.perf_counter()
    n = 0
    for i, batch in enumerate(train):
        for d in batch.data:
            d.wait_to_read()
        n = i + 1
        if n % args.disp_batches == 0:
            print("  test-io batch [%d]\tspeed: %.2f samples/sec"
                  % (i, args.disp_batches * args.batch_size
                     / (time.perf_counter() - tic)))
            tic = time.perf_counter()
    return n, time.perf_counter() - t0


def cifar_fit(pkg, args, network, context=None, kvstore=None,
              arg_params=None, aux_params=None, batch_end_callback=None,
              eval_end_callback=None, iters=None):
    """train_cifar10.py's call of fit.py's fit() in either package: the
    kvstore object of --kv-store (or ``kvstore`` as given: "local" by name
    keeps no store, so the fused step engages), get_rec_iter's iterators
    (or ``iters``, a (train, validation) pair of them shared between
    fits, reset here: their decode pools start once), test_io: the
    iterator alone, no training; then fit_call with the schedule of
    lr_step_epochs, validation data scored each epoch. Returns (module or
    None, train, validation)."""
    kv = pkg.kvstore.create(args.kv_store) if kvstore is None else kvstore
    if iters is None:
        train, val = get_rec_iter(pkg, args,
                                  None if isinstance(kv, str) else kv)
    else:
        train, val = iters
        train.reset()
        val.reset()
    if args.test_io:
        run_test_io(args, train)
        return None, train, val
    lr, lr_scheduler = fit_lr_scheduler(pkg, args.lr, args.lr_factor,
                                        args.lr_step_epochs,
                                        args.num_examples, args.batch_size)
    mod = fit_call(pkg, network, train, val, kv, args.num_epochs, lr,
                   lr_scheduler, args.mom, args.wd, args.batch_size,
                   args.disp_batches, context, arg_params, aux_params,
                   batch_end_callback, eval_end_callback)
    return mod, train, val


def pool_iters(label, *iters):
    """Fail unless each ImageRecordIter serves from the decode pool;
    returns the pools' start-up seconds as text."""
    from mxtpu_torch.image import _FastRecordIter
    for it in iters:
        if not isinstance(it._prefetch, _FastRecordIter):
            fail("%s: ImageRecordIter took the in-process path (%s), not "
                 "the decode pool" % (label, type(it._prefetch).__name__))
    return ", ".join("not in" if it._prefetch.startup_s is None
                     else "%.2f s" % it._prefetch.startup_s for it in iters)


def cifar_staging(mt, train, card, batches=8):
    """The batch's one copy up, as Module.prepare makes it (stage_batch):
    ``batches`` batches drawn from the live iterator and staged behind a
    sleep kernel, each host tensor dropped as soon as its copy is queued,
    so a pinned block reused before its copy ran would show as a batch
    that differs on the card; then the copy's card ms (held_ms) and host
    ms a call from pinned memory beside the same copy from pageable
    memory."""
    import torch
    gpu = mt.gpu(0)
    train.reset()
    train.next()                            # the new epoch's first batch is in
    torch.cuda.synchronize()
    torch.cuda._sleep(1 << 24)              # about 8 ms: the copies queue
    staged = []
    for _ in range(batches):
        batch = train.next()
        want = batch.data[0].asnumpy().copy()
        pinned = batch.data[0].data.is_pinned()
        mt.io.stage_batch(batch, gpu)
        staged.append((batch.data[0], want))
        del batch
    torch.cuda.synchronize()
    for got, want in staged:
        if not np.array_equal(got.asnumpy(), want):
            fail("a staged batch differs from the batch the iterator made: "
                 "its host memory was reused before the copy ran")
    host = staged[0][1]
    sources = {"pinned": torch.from_numpy(host).pin_memory(),
               "pageable": torch.from_numpy(host.copy())}
    text = []
    for name, src in sources.items():
        def copy():
            return src.to(gpu.torch_device(), non_blocking=True)
        card_ms = held_ms(copy, iters=20, required=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            copy()
        host_ms = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        text.append("%s: card %s ms, host %.4f ms a call"
                    % (name, "not held" if card_ms is None
                       else "%.4f" % card_ms, host_ms))
    if not pinned:
        fail("the iterator's batches are not in pinned memory on a host "
             "with a card")
    print("CIFAR batch copy up (%.2f MB, one a step, Module.prepare): %d "
          "batches staged behind a sleep kernel, host tensors dropped, all "
          "equal on the card; %s | %s"
          % (host.nbytes / 1e6, batches, "; ".join(text), card), flush=True)


def cifar_io(mt, args, card, iters):
    """The iterator alone: fit.py's test-io loop over CF_IO_EPOCHS epochs
    of ``iters``' training iterator after its first batch (which waits
    out the pools' start-up), timed: images/s beside the host's cores;
    then the batch's copy up. Returns images/s."""
    train, val = iters
    train.next()
    batches, secs = 0, 0.0
    for epoch in range(CF_IO_EPOCHS):
        if epoch:
            train.reset()
        n, dt = run_test_io(args, train)
        batches, secs = batches + n, secs + dt
    rate = batches * args.batch_size / secs
    cifar_staging(mt, train, card)
    from mxtpu_torch import _image_worker
    decoder = "cv2" if _image_worker._cv2 is not None else "PIL"
    print("CIFAR ImageRecordIter alone (%d %s decode processes, the "
          "pool path; pools' start-up to the first batch: %s): %d "
          "batches of %d in %.3f s, %.1f images/s | os.cpu_count() %d, "
          "sched_getaffinity %d | %s"
          % (args.data_nthreads, decoder, pool_iters("test-io", train, val),
             batches, args.batch_size, secs, rate, os.cpu_count(),
             len(os.sched_getaffinity(0)), card), flush=True)
    return rate


def cifar_val_check(mt, mod, val, train, network, path):
    """``mod``'s validation outputs after its fit (the forward score()
    runs) against an eager Module bound for inference and given the
    weights and moving statistics read from ``mod`` (get_params), both
    under deterministic cuDNN: fails beyond CF_EVAL_TOL. Returns text:
    that Module's accuracy on the validation batches with the moving
    statistics and with each batch's own (its forward in training mode),
    on as many augmented batches drawn from ``train`` with the moving
    statistics, and the mean predicted - true validation class."""
    import torch
    arg, aux = mod.get_params()
    val.reset()
    batches = list(val)
    drawn = [train.next() for _ in batches]
    copy = mt.mod.Module(network, context=mt.gpu(0))
    copy.bind(val.provide_data, val.provide_label, for_training=False)
    copy.set_params(arg, aux)

    def outputs(m, feed, is_train):
        """(softmax, labels) over ``feed``, padded rows dropped."""
        probs, labels = [], []
        for b in feed:
            m.forward(b, is_train=is_train)
            n = b.label[0].shape[0] - b.pad
            probs.append(m.get_outputs()[0].asnumpy()[:n])
            labels.append(b.label[0].asnumpy()[:n])
        return np.concatenate(probs), np.concatenate(labels)

    def accuracy(out):
        return float((out[0].argmax(1) == out[1]).mean())
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        fitted, eager = outputs(mod, batches, False), \
            outputs(copy, batches, False)
    finally:
        torch.backends.cudnn.deterministic = old
    gap = float(np.abs(fitted[0] - eager[0]).max())
    if not gap <= CF_EVAL_TOL:
        fail("CIFAR %s fit: its validation outputs lie %.3g from an eager "
             "Module's given its weights and moving statistics (limit %g)"
             % (path, gap, CF_EVAL_TOL))
    augmented = accuracy(outputs(copy, drawn, False))
    own = accuracy(outputs(copy, batches, True))    # moves copy's statistics
    return ("validation outputs %.3g from an eager copy's (deterministic "
            "cuDNN, limit %g); accuracy with the moving statistics %.4f on "
            "the validation batches, %.4f on %d augmented training batches;"
            " with each validation batch's own statistics %.4f; predicted - "
            "true validation class %.3f on average"
            % (gap, CF_EVAL_TOL, accuracy(fitted), augmented, len(drawn),
               own, float((fitted[0].argmax(1) - fitted[1]).mean())))


def cifar_run(mt, args, network, seed, path, card, learn, iters=None):
    """One cifar_fit on gpu(0) (eager: the kvstore object; captured:
    kvstore="local") over the phase's shared ``iters`` (or its own), its
    pools
    checked, each step's cross-entropy and each epoch's validation
    accuracy read, its validation outputs held to an eager copy's
    (cifar_val_check); ``learn``: the learning check. Returns (module,
    train, validation)."""
    import torch
    ce, val_acc = StepLosses(), []
    np.random.seed(seed)
    mt.random.seed(seed)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mod, train, val = cifar_fit(
        mt, args, network, context=mt.gpu(0),
        kvstore=None if path == "eager" else "local",
        batch_end_callback=[ce], eval_end_callback=lambda p: val_acc.append(
            dict(p.eval_metric.get_name_value())["accuracy"]), iters=iters)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    startup = pool_iters("CIFAR %s fit" % path, train, val)
    if mod._context != [mt.gpu(0)]:
        fail("CIFAR Module context is %s, not gpu(0)" % mod._context)
    per_epoch = args.num_examples // args.batch_size
    steps = args.num_epochs * per_epoch
    text = "eager (the kvstore object fit.py makes)"
    if path == "captured":
        text, entries = capture_report(mod, steps, "CIFAR ResNet-%d"
                                       % args.num_layers)
        text += "; graph (kernel nodes, other nodes, -, replays): %s" % \
            graph_nodes(mt, entries, {}, mt.gpu(0))
        del entries
    losses = ce.values()
    if len(losses) != steps or not np.isfinite(losses).all():
        fail("CIFAR %s fit: %d steps, cross-entropy %s" % (path, len(losses),
                                                          losses))
    first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    if learn and not last < CF_CE_SHARE * first:
        fail("CIFAR %s fit: the cross-entropy of the last 4 steps %.4f is "
             "not below %.2f of the first 4's %.4f"
             % (path, last, CF_CE_SHARE, first))
    ends = ", ".join("%.4f" % np.mean(losses[e - 4:e])
                     for e in range(per_epoch, steps + 1, per_epoch))
    checked = cifar_val_check(mt, mod, val, train, network, path)
    print("CIFAR ResNet-%d Module.fit %s: %d epoch(s) of %d steps at batch %d "
          "in %.2f s (pools' start-up to the first batch: %s); cross-entropy "
          "first 4 steps %.4f, last 4 %.4f%s; last 4 of each epoch %s; "
          "validation accuracy by epoch %s; %s; %s; peak memory %.2f GB | %s"
          % (args.num_layers, path, args.num_epochs, per_epoch,
             args.batch_size, fit_s, startup, first, last,
             " (limit %.4f, %.2f of the first 4's)"
             % (CF_CE_SHARE * first, CF_CE_SHARE) if learn else "", ends,
             ", ".join("%.4f" % a for a in val_acc), checked, text,
             torch.cuda.max_memory_allocated() / 1e9, card), flush=True)
    return mod, train, val


def fed_held_times(mt, runs, label, card, steps, profile_steps, batch,
                   metric, bound_text=None):
    """ms a step of fit's loop body over the live iterators, eager and
    captured, and the captured step repeated on one batch already on the
    card ("fixed": no wait for the iterator), in turns of ``steps`` steps
    (eager, captured, fixed, fixed, captured, eager), with the host time
    by phase (the wait for a batch in "next batch" and "prepare"),
    images/s, ``bound_text(ms)`` (the share of the bound) where given,
    and from torch.profiler over ``profile_steps`` steps the card's busy
    share and launches a step. ``runs``: {path: (module, iterator,
    ...)}; ``metric()`` makes a path's metric. Returns {path: (ms, card
    busy ms or None)}."""
    import torch
    metrics = {k: metric() for k in runs}
    held = {k: None for k in runs}
    ms = {k: [] for k in ("eager", "captured", "fixed")}
    clock = {k: {} for k in runs}
    for k in ("eager", "captured", "fixed", "fixed", "captured", "eager"):
        mod, it = runs["captured" if k == "fixed" else k][:2]
        if k == "fixed":
            fixed = held["captured"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                mod.forward_backward(fixed)
                mod.update()
                mod.update_metric(metrics["captured"], fixed.label)
        else:
            held[k] = fit_steps(mod, it, metrics[k], 1, held[k])[0]  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            held[k] = fit_steps(mod, it, metrics[k], steps, held[k],
                                clock[k])[0]
        torch.cuda.synchronize()
        ms[k].append((time.perf_counter() - t0) / steps * 1e3)
    out = {}
    for k, (mod, it) in ((k, v[:2]) for k, v in runs.items()):
        step = float(np.mean(ms[k]))
        host = "; ".join("%s %.3f" % (p, v / (2 * steps) * 1e3)
                         for p, v in clock[k].items())

        def profiled():
            held[k] = fit_steps(mod, it, metrics[k], profile_steps,
                                held[k])[0]
        busy, top = device_time(profiled, 1, per=profile_steps)
        out[k] = (step, busy)
        print("%s %s step: %.3f ms (%s), %.1f images/s%s; host ms a step by "
              "phase: %s; %s; per step: %s | %s"
              % (label, k, step, ", ".join("%.3f" % v for v in ms[k]),
                 batch / step * 1e3,
                 "; " + bound_text(step) if bound_text else "", host,
                 busy_of(busy, step), top, card), flush=True)
    fixed = float(np.mean(ms["fixed"]))
    out["fixed"] = (fixed, None)
    print("%s step: eager %.3f ms, captured %.3f ms (%.2fx); captured on one "
          "held batch %.3f ms (%s), %.1f images/s | %s"
          % (label, out["eager"][0], out["captured"][0],
             out["eager"][0] / out["captured"][0], fixed,
             ", ".join("%.3f" % v for v in ms["fixed"]), batch / fixed * 1e3,
             card), flush=True)
    return out


def cifar_times(mt, runs, setting, card, bound, batch):
    """:func:`fed_held_times` of the CIFAR fits over the record iterators,
    CF_TIMED_STEPS steps a turn, beside the bound. Returns {path: (ms,
    card busy ms or None)}."""
    tf32 = setting == "TF32 on"
    bound_at, by = bound_ms(*bound, tf32)
    return fed_held_times(
        mt, runs, "CIFAR ResNet-%d, %s (cuDNN TF32 %s, matmul TF32 off):"
        % (CF_LAYERS, setting, "on" if tf32 else "off"), card,
        CF_TIMED_STEPS, CF_PROFILE_STEPS, batch,
        lambda: mt.metric.create([mt.metric.create("accuracy")]),
        lambda step: "bound %.3f ms (%s), %.1f%% of it"
        % (bound_at, by, 100 * bound_at / step))


def cifar_pad_check(mt, network, seed, root, card):
    """A captured fit over CF_PAD_RECORDS records (3 steps an epoch, the
    last padded), 2 epochs, the same records as validation data: one
    capture, a replay in every later step, the padded batches among
    them."""
    args = cifar_args(synthetic=CF_PAD_RECORDS, num_examples=CF_PAD_RECORDS,
                      num_epochs=2, data_nthreads=2)
    args.data_train = args.data_val = make_synthetic_recfile(
        mt, os.path.join(root, "cifar10_pad.rec"), CF_PAD_RECORDS,
        int(args.image_shape.split(",")[1]), args.num_classes)
    pads = []
    np.random.seed(seed)
    mod, train, val = cifar_fit(
        mt, args, network, context=mt.gpu(0), kvstore="local",
        batch_end_callback=[lambda p: pads.append(p.locals["batch"].pad)])
    try:
        pool_iters("CIFAR padded batch", train, val)
        steps = -(-CF_PAD_RECORDS // args.batch_size) * args.num_epochs
        text = capture_report(mod, steps, "CIFAR padded last batch")[0]
        want = [0, 0, steps // 2 * args.batch_size - CF_PAD_RECORDS] * 2
        if pads != want:
            fail("CIFAR padded last batch: pads %s, want %s" % (pads, want))
        print("CIFAR captured fit over %d records at batch %d: pads by step "
              "%s; %s (the padded batches replayed) | %s"
              % (CF_PAD_RECORDS, args.batch_size, pads, text, card),
              flush=True)
    finally:
        train.close()
        val.close()


def cifar_phase(mt, seed, card):
    """train_cifar10.py --synthetic CF_RECORDS's fit call on gpu(0) through
    the port's ImageRecordIter decode pool: the records written under a
    temporary directory, the iterator alone, ResNet-110 eager and captured
    under torch's default TF32 (CF_EPOCHS epochs, the data learnt) and
    captured with TF32 off (one epoch), the steps timed in turns beside the
    bound, and
    the padded last batch replayed. Returns {(path, setting): ms a
    step}."""
    import gc
    import tempfile
    import torch
    clock = [("start", time.perf_counter())]

    def resnet110(pkg):
        return resnet_symbol(pkg, CF_LAYERS, "3,28,28", 10)
    out = {}
    with tempfile.TemporaryDirectory() as root:
        args = cifar_args(synthetic=CF_RECORDS, num_examples=CF_RECORDS,
                          num_epochs=CF_EPOCHS)
        args.data_train, args.data_val = cifar_synthetic(mt, args, root)
        clock.append(("records", time.perf_counter()))
        # one (train, validation) pair of decode pools for every fit of the
        # phase: each pool's start-up took 10-12 s, and the phase started 9
        shared = get_rec_iter(mt, args)
        try:
            io_rate = cifar_io(mt, args, card, shared)
            clock.append(("iterator alone", time.perf_counter()))
            cifar_settings(mt, args, resnet110, seed, card, shared, io_rate,
                           out, clock)
        finally:
            for it in shared:
                it.close()
        cifar_pad_check(mt, resnet110(mt), seed, root, card)
        gc.collect()
        torch.cuda.empty_cache()
        clock.append(("padded batch", time.perf_counter()))
    print("CIFAR phase: %.1f s (%s)" % (
        clock[-1][1] - clock[0][1], ", ".join(
            "%s %.1f" % (name, t - clock[i][1])
            for i, (name, t) in enumerate(clock[1:]))))
    return out


def cifar_settings(mt, args, resnet110, seed, card, shared, io_rate, out,
                   clock):
    """cifar_phase's fits over the ``shared`` iterators: eager and
    captured under torch's default TF32 (CF_EPOCHS epochs, the data
    learnt), then captured with TF32 off (one epoch: a capture keeps the
    kernels it was captured with; the eager step picks them a call, so
    the TF32-on eager module times the TF32-off eager step), each
    setting's steps timed in turns beside the bound; ``out`` gathers
    {(path, setting): ms a step}."""
    import gc
    import torch
    bound = None
    eager = None
    for tf32, setting in ((True, "TF32 on"), (False, "TF32 off")):
        run_args = cifar_args(**vars(args))
        run_args.num_epochs = CF_EPOCHS if tf32 else 1
        runs = {} if eager is None else {"eager": eager}
        with tf32_mode(tf32):
            for path in ("eager", "captured"):
                if path not in runs:
                    runs[path] = cifar_run(mt, run_args, resnet110(mt), seed,
                                           path, card, tf32, shared)
            eager = runs["eager"]
            if bound is None:
                mod, it, _ = runs["eager"]
                conv, matmul, nbytes = step_bound(
                    mt, mod, fit_steps(mod, it, None, 0)[0], 10)
                bound = ((conv, matmul), nbytes)
                print("CIFAR ResNet-%d step at batch %d: %.4g conv FLOPs + "
                      "%.4g matmul FLOPs (FlopCounterMode over one eager "
                      "step; %.4g GMAC an image forward), %.4g bytes to "
                      "move at least; bound %.4f ms with cuDNN TF32, %.4f "
                      "ms in float32 | %s"
                      % (CF_LAYERS, args.batch_size, conv, matmul,
                         (conv + matmul) / 6 / args.batch_size / 1e9,
                         nbytes, bound_ms(*bound, True)[0],
                         bound_ms(*bound, False)[0], card), flush=True)
            if tf32:
                no_sync_epoch(runs["captured"][0], runs["captured"][1],
                              mt.metric.create([mt.metric.create(
                                  "accuracy")]))
            times = cifar_times(mt, runs, setting, card, bound,
                                args.batch_size)
        for path, (ms, busy) in times.items():
            out[path, setting] = ms
        step, busy = times["captured"]
        fixed = times["fixed"][0]
        pace = "the decoders" if step > CF_PACE * fixed else "the card"
        print("CIFAR pace, %s: the captured step %.1f images/s fed by the "
              "decoders, %.1f on one held batch; the decoders alone %.1f "
              "images/s; the card busy %s ms a step: set by %s (the "
              "decoders if the fed step is beyond %.2f of the held one's) | "
              "%s" % (setting, args.batch_size / step * 1e3,
                      args.batch_size / fixed * 1e3, io_rate,
                      "not measured" if busy is None else "%.3f" % busy,
                      pace, CF_PACE, card), flush=True)
        del runs
        gc.collect()
        torch.cuda.empty_cache()
        clock.append(("fits and times, " + setting, time.perf_counter()))
    del eager


# ---------------------------------------------------------------------------
# Phase 17: SSD (BASELINE.json config 5): example/ssd/train_ssd_toy.py, and
# SSD-300 on VGG16-reduced trained from JPEG records through ImageDetIter;
# MultiBoxDetection's greedy NMS on the kernel multibox_nms
# ---------------------------------------------------------------------------

SSD_TOY_HW, SSD_TOY_BATCH, SSD_TOY_EPOCHS = 32, 16, 4
SSD_TOY_SIZES, SSD_TOY_RATIOS = (0.3, 0.45, 0.6), (1.0, 2.0, 0.5)
SSD_TOY_PREFIX = "toyssd0_"
# the toy's first steps on the card (TF32 off) against the CPU's from the
# same weights: each step's mean class and box loss within this; Adam's
# first steps move a weight by about lr whatever its gradient's size, so a
# gradient near 0 whose sign the sum order flips moves its weight the
# other way: the losses, not the weights, are held
SSD_TOY_TOL = dict(rtol=1e-4, atol=1e-6)

# MXNet v1.x example/ssd/symbol/symbol_factory.py,
# get_config("vgg16_reduced", 300): from relu4_3 and relu7, then four extra
# scales (1x1 at num_filters // 2, then 3x3 at the stride and pad)
SSD300 = dict(
    num_filters=(512, -1, 512, 256, 256, 256),
    strides=(-1, -1, 2, 2, 1, 1),
    pads=(-1, -1, 1, 1, 0, 0),
    sizes=((.1, .141), (.2, .272), (.37, .447), (.54, .619), (.71, .79),
           (.88, .961)),
    ratios=((1, 2, .5),) + ((1, 2, .5, 3, 1. / 3),) * 3 + ((1, 2, .5),) * 2,
    normalizations=(20, -1, -1, -1, -1, -1),
    steps=tuple(s / 300.0 for s in (8, 16, 32, 64, 100, 300)))
SSD_CLASSES, SSD_PREFIX = 20, "ssd300_"
SSD_HW, SSD_BATCH, SSD_ANCHORS = 300, 32, 8732
SSD_RECORDS, SSD_EPOCHS = 384, 2             # 12 steps an epoch
SSD_LOSS_STEPS, SSD_LOSS_SHARE = 4, 0.7
SSD_STEPS, SSD_PROFILE_STEPS = 3, 2
# MXNet SSD's train_net.py: SGD 0.004 / 0.9 / 5e-4, rescale_grad 1 (the
# loss is normalized by the valid anchors already), Xavier(gaussian, out, 2)
SSD_OPT = {"learning_rate": 0.004, "momentum": 0.9, "wd": 5e-4}
SSD_TARGET = dict(overlap_threshold=0.5, ignore_label=-1.0,
                  negative_mining_ratio=3.0, negative_mining_thresh=0.5,
                  variances=(0.1, 0.1, 0.2, 0.2))
SSD_AUG = dict(rand_crop=1, rand_pad=1, rand_mirror=True, mean=True,
               std=True)
SSD_NMS_THRESHOLD = 0.45                     # example/ssd's deploy nms_thresh
SSD_MAX_OBJECTS = 3
# the kernel against its plain version: class ids equal, floats within
DET_TOL = dict(atol=1e-6, rtol=0)
# MultiBoxTarget's box targets on the card against the CPU: torch.log on
# the card may differ from the CPU's in the last place
TARGET_TOL = dict(atol=1e-5, rtol=1e-5)
# operations a tested pair costs the kernel (IoU: 4 min/max, 5 subtractions,
# 4 clamps, 3 products, a sum, a quotient, 2 comparisons, the class test)
NMS_PAIR_OPS = 21
# the tied-score and force_suppress cases at SSD-300's first 2,048 anchors:
# the plain loop they are held to costs a launch a row
NMS_CUT_ROWS = 2048


def synthetic_detection_set(n=64, hw=32, seed=0):
    """train_ssd_toy.py:28-41: images with one bright square; the label is
    its box, class 0."""
    rng = np.random.RandomState(seed)
    images, labels = [], []
    for _ in range(n):
        img = rng.randint(0, 40, (hw, hw, 3)).astype(np.uint8)
        size = rng.randint(8, 16)
        y0 = rng.randint(0, hw - size)
        x0 = rng.randint(0, hw - size)
        img[y0:y0 + size, x0:x0 + size] = 230
        images.append(img)
        labels.append(np.array([[0, x0 / hw, y0 / hw,
                                 (x0 + size) / hw, (y0 + size) / hw]],
                               np.float32))
    return images, labels


def toy_ssd(pkg, num_anchors, prefix=SSD_TOY_PREFIX):
    """train_ssd_toy.py:44-63's ToySSD in either package, its layers made
    under its name scope so that names match across packages."""
    nn = pkg.gluon.nn

    class ToySSD(pkg.gluon.HybridBlock):
        """Tiny single-scale SSD head."""

        def __init__(self, num_anchors, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.backbone = nn.HybridSequential()
                for ch in (16, 32):
                    self.backbone.add(nn.Conv2D(ch, 3, padding=1),
                                      nn.BatchNorm(),
                                      nn.Activation("relu"),
                                      nn.MaxPool2D(2))
                self.cls_head = nn.Conv2D(num_anchors * 2, 3, padding=1)
                self.box_head = nn.Conv2D(num_anchors * 4, 3, padding=1)

        def hybrid_forward(self, F, x):
            feat = self.backbone(x)
            cls = self.cls_head(feat)      # [B, A*2, H, W]
            box = self.box_head(feat)      # [B, A*4, H, W]
            return feat, cls, box

    return ToySSD(num_anchors, prefix=prefix)


def toy_sample():
    """The toy's first image as its main feeds it: [1, 3, 32, 32] in
    [0, 1]."""
    images, _ = synthetic_detection_set(hw=SSD_TOY_HW)
    return images[0].transpose(2, 0, 1)[None].astype(np.float32) / 255.0


def ssd_toy_main(pkg, ctx, weights=None, max_steps=None):
    """train_ssd_toy.py's main (:66-119), line for line, in either package
    on ``ctx``: the toy set, ToySSD with Xavier, Adam 2e-3, 4 epochs of
    batch 16 (SoftmaxCrossEntropyLoss on the classes, L1Loss on the masked
    boxes, targets by MultiBoxTarget), then one image decoded through
    MultiBoxDetection. ``weights`` ({name: numpy}) replace the Xavier
    draws (the packages draw differently); ``max_steps`` stops early.
    Returns {"net", "steps": [(cls, box) a step], "epochs": [(cls, box)
    an epoch], "det": the decoded image's rows}."""
    nd, autograd, gluon = pkg.nd, pkg.autograd, pkg.gluon
    with ctx:
        pkg.random.seed(0)
        np.random.seed(0)
        hw = SSD_TOY_HW
        sizes, ratios = SSD_TOY_SIZES, SSD_TOY_RATIOS
        num_anchors = len(sizes) + len(ratios) - 1

        images, labels = synthetic_detection_set(hw=hw)
        net = toy_ssd(pkg, num_anchors)
        net.initialize(pkg.init.Xavier(), ctx=ctx)
        if weights is not None:
            net(nd.array(toy_sample(), ctx=ctx))
            gluon_load(pkg, net, weights, ctx)
        trainer = gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 2e-3})
        cls_loss = gluon.loss.SoftmaxCrossEntropyLoss()
        box_loss = gluon.loss.L1Loss()

        batch_size = SSD_TOY_BATCH
        steps, epochs = [], []
        for epoch in range(SSD_TOY_EPOCHS):
            tot_c = tot_b = 0.0
            for i in range(0, len(images), batch_size):
                if max_steps is not None and len(steps) == max_steps:
                    break
                x = nd.array(np.stack(
                    [im.transpose(2, 0, 1) for im in
                     images[i:i + batch_size]]).astype(np.float32) / 255.0)
                y = nd.array(np.stack(labels[i:i + batch_size]))
                with autograd.record():
                    feat, cls, box = net(x)
                    anchors = nd.contrib.MultiBoxPrior(
                        feat, sizes=sizes, ratios=ratios)
                    b = cls.shape[0]
                    cls_pred = nd.transpose(cls, (0, 2, 3, 1)).reshape(
                        (b, -1, 2))
                    box_pred = nd.transpose(box, (0, 2, 3, 1)).reshape(
                        (b, -1))
                    box_target, box_mask, cls_target = \
                        nd.contrib.MultiBoxTarget(
                            anchors, y, nd.transpose(cls_pred, (0, 2, 1)))
                    lc = cls_loss(cls_pred, cls_target)
                    lb = box_loss(box_pred * box_mask, box_target)
                    loss = lc + lb
                loss.backward()
                trainer.step(b)
                c, bx = float(lc.mean().asnumpy()), float(lb.mean().asnumpy())
                steps.append((c, bx))
                tot_c += c
                tot_b += bx
            nb = len(images) / batch_size
            epochs.append((tot_c / nb, tot_b / nb))

        # decode detections for one image
        feat, cls, box = net(nd.array(toy_sample()))
        anchors = nd.contrib.MultiBoxPrior(feat, sizes=sizes, ratios=ratios)
        cls_pred = nd.transpose(cls, (0, 2, 3, 1)).reshape((1, -1, 2))
        probs = nd.transpose(nd.softmax(cls_pred, axis=-1), (0, 2, 1))
        box_pred = nd.transpose(box, (0, 2, 3, 1)).reshape((1, -1))
        det = nd.contrib.MultiBoxDetection(probs, box_pred, anchors,
                                           nms_threshold=0.5)
        return {"net": net, "steps": steps, "epochs": epochs,
                "det": det.asnumpy()}


def ssd300_feature_hw(hw=SSD_HW):
    """The sides of SSD-300's six feature maps at an input of ``hw``:
    relu4_3 after pools 1-3 (pool3 rounding up), relu7 after pool4 (pool5,
    fc6 and fc7 keep the side), then each extra scale's 3x3 convolution."""
    side = (hw - 2) // 2 + 1
    side = (side - 2) // 2 + 1
    side = -(-(side - 2) // 2) + 1
    sides = [side, (side - 2) // 2 + 1]
    for stride, pad in zip(SSD300["strides"][2:], SSD300["pads"][2:]):
        sides.append((sides[-1] + 2 * pad - 3) // stride + 1)
    return sides


def ssd300_vgg16(pkg, width_div=1, classes=SSD_CLASSES, prefix=SSD_PREFIX):
    """SSD-300 on VGG16-reduced (SSD300's config) as a Gluon HybridBlock in
    either package: VGG16 through relu4_3 (pool3 rounding up: 75 -> 38),
    pool4, conv5, pool5 (3x3, stride 1, pad 1), fc6 (3x3, dilation 6,
    1,024), fc7 (1x1, 1,024), four extra scales; relu4_3 L2-normalized
    over channels times a learnt per-channel scale (initialized to 20);
    a 3x3 class head (A * (classes + 1)) and box head (A * 4) a scale,
    each NCHW -> NHWC, flattened and concatenated over the scales. Returns
    (class predictions [B, classes + 1, anchors], box predictions
    [B, anchors * 4]). ``width_div`` divides every channel width (the CPU
    tests run 300x300 at 1/8)."""
    nn = pkg.gluon.nn
    cfg = SSD300

    def width(c):
        return max(1, c // width_div)

    def conv(seq, channels, kernel=3, **kw):
        seq.add(nn.Conv2D(width(channels), kernel, **kw),
                nn.Activation("relu"))

    class SSD300VGG16(pkg.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.to_relu4_3 = nn.HybridSequential()
                for stage, (n, c) in enumerate(((2, 64), (2, 128), (3, 256),
                                                (3, 512))):
                    if stage:
                        self.to_relu4_3.add(nn.MaxPool2D(
                            pool_size=2, strides=2, ceil_mode=stage == 3))
                    for _ in range(n):
                        conv(self.to_relu4_3, c, padding=1)
                self.scale = self.params.get(
                    "relu4_3_scale", shape=(1, width(512), 1, 1),
                    init=pkg.init.Constant(cfg["normalizations"][0]))
                self.to_relu7 = nn.HybridSequential()
                self.to_relu7.add(nn.MaxPool2D(pool_size=2, strides=2))
                for _ in range(3):
                    conv(self.to_relu7, 512, padding=1)
                self.to_relu7.add(nn.MaxPool2D(pool_size=3, strides=1,
                                               padding=1))
                conv(self.to_relu7, 1024, padding=6, dilation=6)   # fc6
                conv(self.to_relu7, 1024, kernel=1)                # fc7
                self.extras = nn.HybridSequential()
                for nf, stride, pad in zip(cfg["num_filters"][2:],
                                           cfg["strides"][2:],
                                           cfg["pads"][2:]):
                    extra = nn.HybridSequential()
                    conv(extra, nf // 2, kernel=1)
                    conv(extra, nf, strides=stride, padding=pad)
                    self.extras.add(extra)
                self.cls_heads = nn.HybridSequential()
                self.box_heads = nn.HybridSequential()
                for sizes, ratios in zip(cfg["sizes"], cfg["ratios"]):
                    a = len(sizes) + len(ratios) - 1
                    self.cls_heads.add(nn.Conv2D(a * (classes + 1), 3,
                                                 padding=1))
                    self.box_heads.add(nn.Conv2D(a * 4, 3, padding=1))

        def hybrid_forward(self, F, x, scale):
            x = self.to_relu4_3(x)
            feats = [F.broadcast_mul(F.L2Normalization(x, mode="channel"),
                                     scale)]
            x = self.to_relu7(x)
            feats.append(x)
            for extra in self.extras:
                x = extra(x)
                feats.append(x)
            cls, box = [], []
            for feat, cls_head, box_head in zip(feats, self.cls_heads,
                                                self.box_heads):
                cls.append(F.Flatten(F.transpose(cls_head(feat),
                                                 axes=(0, 2, 3, 1))))
                box.append(F.Flatten(F.transpose(box_head(feat),
                                                 axes=(0, 2, 3, 1))))
            cls = F.reshape(F.concat(*cls, dim=1), shape=(0, -1, classes + 1))
            return F.transpose(cls, axes=(0, 2, 1)), F.concat(*box, dim=1)

    return SSD300VGG16(prefix=prefix)


def ssd300_xavier(pkg):
    """MXNet SSD's initializer: Xavier(gaussian, out, magnitude 2)."""
    return pkg.init.Xavier(rnd_type="gaussian", factor_type="out",
                           magnitude=2)


def ssd300_anchors(pkg, ctx, hw=SSD_HW):
    """[1, 8,732, 4] at 300: nd.contrib.MultiBoxPrior a scale, at its
    sizes, ratios and step, concatenated (outside the block, as the toy
    computes its anchors)."""
    return pkg.nd.concat(*[
        pkg.nd.contrib.MultiBoxPrior(pkg.nd.zeros((1, 1, side, side),
                                                  ctx=ctx),
                                     sizes=sizes, ratios=ratios,
                                     steps=(step, step))
        for side, sizes, ratios, step in zip(
            ssd300_feature_hw(hw), SSD300["sizes"], SSD300["ratios"],
            SSD300["steps"])], dim=1)


def ssd_targets(pkg, anchors, label, cls_preds):
    """MultiBoxTarget at MXNet SSD's settings: (box_target, box_mask,
    cls_target)."""
    return pkg.nd.contrib.MultiBoxTarget(anchors, label, cls_preds,
                                         **SSD_TARGET)


def ssd_loss(pkg, cls_preds, box_preds, targets):
    """MXNet SSD's training loss from MultiBoxTarget's ``targets``: the
    softmax cross-entropy of each anchor whose class target is not
    ignored, and smooth_l1(box_mask * (box_pred - box_target), scalar=1),
    both summed and divided by the count of those valid anchors (the
    SoftmaxOutput and MakeLoss of ``normalization="valid"``). Returns
    (class loss, box loss)."""
    nd = pkg.nd
    box_target, box_mask, cls_target = targets
    valid = cls_target >= 0
    n_valid = nd.clip(nd.sum(valid), a_min=1.0)
    logp = nd.log_softmax(cls_preds, axis=1)
    ce = -nd.pick(logp, nd.clip(cls_target, a_min=0.0), axis=1)
    cls_loss = nd.sum(ce * valid) / n_valid
    box_loss = nd.sum(nd.smooth_l1(box_mask * (box_preds - box_target),
                                   scalar=1.0)) / n_valid
    return cls_loss, box_loss


class SSDRun:
    """MXNet SSD's training step over ``net`` on ``ctx``: ``with
    autograd.record()``: the net, MultiBoxTarget, the loss; ``backward``;
    ``Trainer.step(1)`` (SGD, SSD_OPT). ``steps(n, it)`` takes batches from
    the iterator ``it`` (a new epoch where one ends; each copied to
    ``ctx``), ``held(n)`` repeats one batch kept on ``ctx``. Each step's
    (class, box) losses stay on the device; ``clock`` gathers the host
    seconds of each phase."""

    def __init__(self, pkg, net, anchors, ctx, hybridize):
        self.pkg, self.net, self.anchors, self.ctx = pkg, net, anchors, ctx
        if hybridize:
            net.hybridize()
        self.trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                         dict(SSD_OPT))
        self.losses = []
        self.clock = {}
        self.batch = None

    def _next(self, it):
        for _ in range(2):
            try:
                b = it.next()
            except StopIteration:
                it.reset()
                continue
            return (b.data[0].as_in_context(self.ctx),
                    b.label[0].as_in_context(self.ctx))
        raise RuntimeError("the iterator gave no batch")

    def step(self, x, y, t0):
        pkg, clock = self.pkg, self.clock
        t1 = time.perf_counter()
        with pkg.autograd.record():
            cls_preds, box_preds = self.net(x)
            t2 = time.perf_counter()
            targets = ssd_targets(pkg, self.anchors, y, cls_preds)
            t3 = time.perf_counter()
            lc, lb = ssd_loss(pkg, cls_preds, box_preds, targets)
            loss = lc + lb
        loss.backward()
        t4 = time.perf_counter()
        self.trainer.step(1)
        t5 = time.perf_counter()
        self.losses.append((lc, lb))
        for phase, dt in (("next", t1 - t0), ("forward/backward",
                                              (t2 - t1) + (t4 - t3)),
                          ("MultiBoxTarget", t3 - t2),
                          ("trainer.step", t5 - t4)):
            clock[phase] = clock.get(phase, 0.0) + dt

    def steps(self, n, it):
        for _ in range(n):
            t0 = time.perf_counter()
            x, y = self._next(it)
            self.step(x, y, t0)
        return self

    def held(self, n):
        for _ in range(n):
            self.step(*self.batch, time.perf_counter())
        return self

    def loss_values(self):
        return [float((c + b).asscalar()) for c, b in self.losses]


def ssd_records(pkg, path, n, hw=SSD_HW, seed=0, quality=95):
    """``n`` synthetic JPEG records of ``hw`` x ``hw``: a noise background
    and one to three axis-aligned rectangles of SSD_CLASSES classes, each
    class its own colour from a palette drawn from ``seed``; the label is
    ImageDetIter's flat [2, 5, (class, x0, y0, x1, y1) an object], the
    corners normalized."""
    rng = np.random.RandomState(seed)
    palette = np.random.RandomState(1234).randint(0, 256, (SSD_CLASSES, 3))
    writer = pkg.recordio.MXRecordIO(path, "w")
    for i in range(n):
        img = rng.randint(80, 176, (hw, hw, 3)).astype(np.uint8)
        objs = []
        for _ in range(rng.randint(1, SSD_MAX_OBJECTS + 1)):
            c = rng.randint(SSD_CLASSES)
            w, h = rng.randint(hw // 10, hw // 2, 2)
            x0, y0 = rng.randint(0, hw - w), rng.randint(0, hw - h)
            img[y0:y0 + h, x0:x0 + w] = palette[c]
            objs.append([c, x0 / hw, y0 / hw, (x0 + w) / hw, (y0 + h) / hw])
        label = np.concatenate([[2, 5], np.ravel(objs)]).astype(np.float32)
        writer.write(pkg.recordio.pack_img(
            pkg.recordio.IRHeader(0, label, i, 0), img, quality=quality))
    writer.close()
    return path


def det_iter(pkg, path, batch, augment, seed):
    """ImageDetIter over ``path`` at SSD_HW with SSD_AUG (``augment``) or
    mean/std only, Python's random seeded with ``seed``."""
    random.seed(seed)
    aug = dict(SSD_AUG) if augment else dict(mean=True, std=True)
    return pkg.image.ImageDetIter(batch, (3, SSD_HW, SSD_HW),
                                  path_imgrec=path, shuffle=augment, **aug)


def nms_inputs(vision, anchors, rng, batch, tied=False):
    """MultiBoxDetection's rows before the NMS at SSD-300's shape: softmax
    probabilities over 21 classes and box offsets from ``rng``, decoded
    against ``anchors`` (on their device). ``tied`` rounds the
    probabilities to sixteenths, so rows tie and many fall below the
    threshold."""
    import torch
    num = anchors.shape[1]
    logits = rng.standard_normal((batch, SSD_CLASSES + 1, num)) * 3
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    if tied:
        probs = np.round(probs * 16) / 16
    loc = 0.5 * rng.standard_normal((batch, num * 4))
    dev = anchors.device
    return vision.detection_rows(
        torch.tensor(probs, dtype=torch.float32, device=dev),
        torch.tensor(loc, dtype=torch.float32, device=dev), anchors)


def nms_pairs(vision, cls_id, boxes, force, limit,
              threshold=SSD_NMS_THRESHOLD):
    """The (row, later row) IoU tests the greedy pass needs on these rows:
    for each row i < limit alive at its turn with a class, the later rows
    still alive then of its class (any class with ``force``), a pair
    suppressing its later row above ``threshold``. The kernel's
    operations are these pairs times NMS_PAIR_OPS."""
    import torch
    num = cls_id.shape[1]
    j = torch.arange(num, device=cls_id.device)
    alive = torch.ones_like(cls_id, dtype=torch.bool)
    pairs = torch.zeros((), dtype=torch.int64, device=cls_id.device)
    for i in range(limit):
        ci = cls_id[:, i:i + 1]
        live = alive[:, i:i + 1] & (ci >= 0)
        cand = live & alive & (j > i) & ((ci == cls_id) | force)
        pairs += cand.sum()
        iou = vision._corner_iou(boxes[:, i:i + 1], boxes)
        alive = alive & ~(cand & (iou > threshold))
    return int(pairs)


def nms_kernel_phase(mt, vision, rng, card):
    """multibox_nms against its plain version on the card at SSD-300's
    shape (8,732 anchors, 21 classes): batch 1 and 8, tied scores and
    force_suppress (at the first NMS_CUT_ROWS anchors), nms_topk=400;
    each kernel call twice for the same
    bits, class ids equal to the plain loop's. Then the kernel's and the
    plain loop's times at batch 1 and 8 beside the bound. Returns
    (largest error, {batch: (ms, plain ms, bound ms, bound by)})."""
    import torch
    anchors = ssd300_anchors(mt, mt.gpu(0)).data
    if anchors.shape[1] != SSD_ANCHORS:
        fail("SSD-300 has %d anchors, not %d" % (anchors.shape[1],
                                                 SSD_ANCHORS))
    worst, timing = 0.0, {}
    for label, batch, rows, tied, force, topk in (
            ("batch 1", 1, SSD_ANCHORS, False, False, -1),
            ("batch 8", 8, SSD_ANCHORS, False, False, -1),
            ("tied scores", 8, NMS_CUT_ROWS, True, False, -1),
            ("force_suppress", 8, NMS_CUT_ROWS, False, True, -1),
            ("nms_topk 400", 8, SSD_ANCHORS, False, False, 400)):
        cls_id, score, boxes = nms_inputs(vision, anchors[:, :rows], rng,
                                          batch, tied)
        limit = rows if topk <= 0 else topk
        got = vision.multibox_nms(boxes, cls_id, SSD_NMS_THRESHOLD, force,
                                  limit)
        again = vision.multibox_nms(boxes, cls_id, SSD_NMS_THRESHOLD, force,
                                    limit)
        # the plain loop's one call, timed with events (its time for the
        # JSON line, where the case is one of the batches)
        box = []
        plain_ms = cuda_ms(lambda: box.append(vision.multibox_nms_plain(
            boxes, cls_id, SSD_NMS_THRESHOLD, force, limit)), iters=1,
            warmup=0)
        want = box[0]
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail("multibox_nms %s: two calls differ" % label)
        if not torch.equal(got, want):
            fail("multibox_nms %s: %d of %d class ids differ from the plain "
                 "loop" % (label, int((got != want).sum()), got.numel()))
        worst = max(worst, float((got - want).abs().max()))
        kept = int((got >= 0).sum())
        print("multibox_nms %s (%d x %d rows, %d with a class): %d kept, "
              "equal to the plain loop, bitwise repeatable"
              % (label, batch, rows, int((cls_id >= 0).sum()), kept),
              flush=True)
        if label.startswith("batch"):
            ms = cuda_ms(lambda: vision.multibox_nms(
                boxes, cls_id, SSD_NMS_THRESHOLD, False, limit), iters=20)
            pairs = nms_pairs(vision, cls_id, boxes, False, limit)
            ops_ms = pairs * NMS_PAIR_OPS / PEAK_F32 * 1e3
            bytes_ms = batch * SSD_ANCHORS * (16 + 4 + 4) / PEAK_BYTES_S * 1e3
            bound, by = (ops_ms, "operations") if ops_ms >= bytes_ms else \
                (bytes_ms, "bytes")
            timing[batch] = (ms, plain_ms, bound, by)
            print("time multibox_nms %s: %.4f ms (CUDA events, 20 calls), "
                  "plain loop %.2f ms; %d pairs tested; bound %.6f ms (%s), "
                  "the kernel at %.3f%% of it; no library call | %s"
                  % (label, ms, plain_ms, pairs, bound, by,
                     100 * bound / ms, card), flush=True)
    return worst, timing


def multibox_card_check(mt, rng, card):
    """MultiBoxPrior, Target (mining on) and Detection on cuda:0 against
    the CPU at SSD-300's shapes: batch 32, one to three objects an image
    (the rest -1), 8,732 anchors, 21 classes. cls_target and box_mask
    equal, box_target within TARGET_TOL; the detections' class ids
    equal, the rest within DET_TOL."""
    import torch
    gpu, cpu = mt.gpu(0), mt.cpu()
    nd = mt.nd
    anchors = {"gpu": ssd300_anchors(mt, gpu), "cpu": ssd300_anchors(mt, cpu)}
    if not torch.equal(anchors["gpu"].data.cpu(), anchors["cpu"].data):
        fail("MultiBoxPrior on the card differs from the CPU")
    label = np.full((SSD_BATCH, SSD_MAX_OBJECTS, 5), -1.0, np.float32)
    for i in range(SSD_BATCH):
        n = rng.randint(1, SSD_MAX_OBJECTS + 1)
        xy = rng.uniform(0, 0.7, (n, 2))
        wh = rng.uniform(0.05, 0.3, (n, 2))
        label[i, :n] = np.concatenate(
            [rng.randint(0, SSD_CLASSES, (n, 1)), xy, xy + wh], 1)
    preds = rng.standard_normal((SSD_BATCH, SSD_CLASSES + 1, SSD_ANCHORS)
                                ).astype(np.float32)
    outs = {}
    for name, ctx in (("gpu", gpu), ("cpu", cpu)):
        outs[name] = [o.data.cpu() for o in ssd_targets(
            mt, anchors[name], nd.array(label, ctx=ctx),
            nd.array(preds, ctx=ctx))]
    (bt, bm, ct), (bt_c, bm_c, ct_c) = outs["gpu"], outs["cpu"]
    if not (torch.equal(ct, ct_c) and torch.equal(bm, bm_c)):
        fail("MultiBoxTarget on the card: %d class targets and %d mask "
             "entries differ from the CPU" % (int((ct != ct_c).sum()),
                                             int((bm != bm_c).sum())))
    check_close("MultiBoxTarget box_target", [bt], [bt_c], TARGET_TOL)
    probs = rng.standard_normal(preds.shape) * 3
    probs = np.exp(probs - probs.max(1, keepdims=True))
    probs = (probs / probs.sum(1, keepdims=True)).astype(np.float32)
    loc = (0.5 * rng.standard_normal((SSD_BATCH, SSD_ANCHORS * 4))).astype(
        np.float32)
    det = {}
    for name, ctx in (("gpu", gpu), ("cpu", cpu)):
        det[name] = nd.contrib.MultiBoxDetection(
            nd.array(probs, ctx=ctx), nd.array(loc, ctx=ctx), anchors[name],
            nms_threshold=SSD_NMS_THRESHOLD).data.cpu()
    if not torch.equal(det["gpu"][..., 0], det["cpu"][..., 0]):
        fail("MultiBoxDetection on the card: %d class ids differ from the "
             "CPU" % int((det["gpu"][..., 0] != det["cpu"][..., 0]).sum()))
    check_close("MultiBoxDetection", [det["gpu"]], [det["cpu"]], DET_TOL)
    print("MultiBox ops on the card against the CPU at batch %d, %d "
          "anchors: anchors equal; MultiBoxTarget (mining 3:1) class "
          "targets equal (%d positive, %d negative, %d ignored), box targets "
          "within %g; MultiBoxDetection class ids equal (%d kept), floats "
          "within %g" % (SSD_BATCH, SSD_ANCHORS, int((ct > 0).sum()),
                         int((ct == 0).sum()), int((ct < 0).sum()),
                         float((bt - bt_c).abs().max()),
                         int((det["gpu"][..., 0] >= 0).sum()),
                         float((det["gpu"] - det["cpu"]).abs().max())),
          flush=True)


def toy_card_phase(mt, card):
    """train_ssd_toy.py's main on gpu(0) from the CPU's Xavier draws: its
    first 3 steps' losses against the CPU's (SSD_TOY_TOL), its 4 epochs'
    class and box losses falling, the decoded image's rows finite."""
    cpu, gpu = mt.cpu(), mt.gpu(0)
    num_anchors = len(SSD_TOY_SIZES) + len(SSD_TOY_RATIOS) - 1
    w0 = gluon_weights(mt, toy_ssd(mt, num_anchors), 0, toy_sample(),
                       init=mt.init.Xavier())
    want = ssd_toy_main(mt, cpu, w0, max_steps=FIT_STEPS)["steps"]
    t0 = time.perf_counter()
    run = ssd_toy_main(mt, gpu, w0)
    secs = time.perf_counter() - t0
    got = run["steps"][:FIT_STEPS]
    if not np.allclose(got, want, **SSD_TOY_TOL):
        fail("the toy SSD's first %d steps on the card %s, on the CPU %s "
             "(%s)" % (FIT_STEPS, got, want, SSD_TOY_TOL))
    (c0, b0), (c1, b1) = run["epochs"][0], run["epochs"][-1]
    if not (c1 < c0 and b1 < b0):
        fail("the toy SSD's losses did not fall: %s" % run["epochs"])
    det = run["det"]
    if det.shape != (1, 8 * 8 * num_anchors, 6) or \
            not np.isfinite(det).all():
        fail("the toy's detections: %s" % (det.shape,))
    print("toy SSD (train_ssd_toy.py's main) on gpu(0): %d steps in %.2f s; "
          "first %d steps within %s of the CPU's (largest gap %.3g); epochs' "
          "(class, box) losses %s; top detection %s | %s"
          % (len(run["steps"]), secs, FIT_STEPS, SSD_TOY_TOL,
             float(np.abs(np.subtract(got, want)).max()),
             ", ".join("(%.4f, %.4f)" % e for e in run["epochs"]),
             np.round(det[0, 0], 3).tolist(), card), flush=True)


def ssd300_step_bound(mt, run):
    """One eager held step of ``run`` under FlopCounterMode: ((conv FLOPs,
    matmul FLOPs), bytes a step must move: the batch and its labels read,
    every weight and momentum read and written)."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        run.held(1)
    by_op = counter.get_flop_counts().get("Global", {})
    conv = sum(v for k, v in by_op.items() if "convolution" in str(k))
    matmul = counter.get_total_flops() - conv
    n_param = sum(p.data().size for p in run.net.collect_params().values())
    nbytes = 4 * (SSD_BATCH * 3 * SSD_HW * SSD_HW
                  + SSD_BATCH * SSD_MAX_OBJECTS * 5 + 2 * 2 * n_param)
    return (conv, matmul), nbytes


def ssd300_train(mt, w0, anchors, path, path_label, hybridize, seed, card):
    """SSD-300 from ``w0`` on gpu(0), eager or hybridized, fed by
    ImageDetIter (SSD_AUG) for SSD_EPOCHS epochs: the last SSD_LOSS_STEPS
    steps' loss below SSD_LOSS_SHARE of the first's. Returns the run and
    its iterator."""
    import torch
    gpu = mt.gpu(0)
    net = gluon_load(mt, ssd300_vgg16(mt), w0, gpu)
    run = SSDRun(mt, net, anchors, gpu, hybridize)
    it = det_iter(mt, path, SSD_BATCH, True, seed)
    steps = SSD_EPOCHS * SSD_RECORDS // SSD_BATCH
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run.steps(steps, it)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    losses = run.loss_values()
    if not all(np.isfinite(losses)):
        fail("SSD-300 %s: losses %s" % (path_label, losses))
    first = float(np.mean(losses[:SSD_LOSS_STEPS]))
    last = float(np.mean(losses[-SSD_LOSS_STEPS:]))
    if not last < SSD_LOSS_SHARE * first:
        fail("SSD-300 %s: the loss went from %.4f (first %d steps) to %.4f "
             "(last %d) over %d steps; limit %.2f of the first"
             % (path_label, first, SSD_LOSS_STEPS, last, SSD_LOSS_STEPS,
                steps, SSD_LOSS_SHARE))
    text = "eager" if not hybridize else hybrid_report(
        net, "SSD-300", steps)
    print("SSD-300 %s: %d steps (%d epochs of %d records, batch %d) from "
          "ImageDetIter in %.2f s; loss (class + box) of the first %d steps "
          "%.4f, of the last %d %.4f (limit %.2f of the first); %s; peak "
          "memory %.2f GB | %s"
          % (path_label, steps, SSD_EPOCHS, SSD_RECORDS, SSD_BATCH, secs,
             SSD_LOSS_STEPS, first, SSD_LOSS_STEPS, last, SSD_LOSS_SHARE,
             text, torch.cuda.max_memory_allocated() / 1e9, card),
          flush=True)
    run.clock.clear()
    return run, it


def ssd300_phase(mt, vision, seed, card, workdir):
    """SSD-300 at full width (BASELINE.json config 5), batch 32, f32 under
    torch's default TF32 (cuDNN on, matmuls off), from SSD_RECORDS
    synthetic JPEG records through ImageDetIter: the iterator alone; eager
    and hybridized training, each learning; both timed in turns fed by
    the iterator and on one batch held on the card; FLOPs and the bound;
    a held-out image decoded through MultiBoxDetection on the kernel
    against the CPU's plain loop on the same outputs. Returns {(path,
    feed): ms a step}."""
    import torch
    gpu, cpu = mt.gpu(0), mt.cpu()
    t0 = time.perf_counter()
    path = ssd_records(mt, os.path.join(workdir, "ssd_train.rec"),
                       SSD_RECORDS, seed=seed)
    held_path = ssd_records(mt, os.path.join(workdir, "ssd_val.rec"), 1,
                            seed=seed + 1)
    print("SSD-300 records: %d JPEGs of %dx%d written in %.2f s (%.1f MB)"
          % (SSD_RECORDS, SSD_HW, SSD_HW, time.perf_counter() - t0,
             os.path.getsize(path) / 1e6), flush=True)
    it = det_iter(mt, path, SSD_BATCH, True, seed)
    n = 0
    t0 = time.perf_counter()
    for batch in it:
        n += batch.data[0].shape[0]
        if batch.data[0].shape != (SSD_BATCH, 3, SSD_HW, SSD_HW) or \
                batch.label[0].shape != (SSD_BATCH, SSD_MAX_OBJECTS, 5):
            fail("ImageDetIter batch %s / %s" % (batch.data[0].shape,
                                                 batch.label[0].shape))
    io_rate = n / (time.perf_counter() - t0)
    print("ImageDetIter alone (in-process decode + SSD augmentation, one "
          "epoch): %.1f images/s on %d host cores | %s"
          % (io_rate, os.cpu_count(), card), flush=True)
    anchors = ssd300_anchors(mt, gpu)
    out = {}
    with tf32_mode(True):
        mt.random.seed(seed)
        net = ssd300_vgg16(mt)
        net.initialize(ssd300_xavier(mt), ctx=gpu)
        net(mt.nd.zeros((1, 3, SSD_HW, SSD_HW), ctx=gpu))
        w0 = gluon_values(net)
        del net
        runs = {}
        for path_label, hyb in (("eager", False), ("hybridized", True)):
            runs[path_label] = ssd300_train(mt, w0, anchors, path,
                                            path_label, hyb, seed, card)
        for run, it in runs.values():
            x, y = run._next(it)
            run.batch = (x, y)
        ms, clocks = {}, {}
        for path_label in ("eager", "hybridized", "hybridized", "eager"):
            run, it = runs[path_label]
            for feed in ("fed", "held"):
                run.clock = clocks.setdefault((path_label, feed), {})
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if feed == "fed":
                    run.steps(SSD_STEPS, it)
                else:
                    run.held(SSD_STEPS)
                torch.cuda.synchronize()
                ms.setdefault((path_label, feed), []).append(
                    (time.perf_counter() - t0) / SSD_STEPS * 1e3)
        for run, _it in runs.values():
            run.clock = {}            # the untimed steps below
        flops, nbytes = ssd300_step_bound(mt, runs["eager"][0])
        conv, matmul = flops
        on, by_on = bound_ms(flops, nbytes, True)
        off, by_off = bound_ms(flops, nbytes, False)
        print("SSD-300 step at batch %d: %.4g conv FLOPs + %.4g matmul FLOPs "
              "(FlopCounterMode over one eager step; %.3g GMAC an image "
              "forward), %.4g bytes to move at least; bound %.3f ms (%s) "
              "with cuDNN TF32, %.3f ms (%s) in float32 | %s"
              % (SSD_BATCH, conv, matmul, (conv + matmul) / 6 / SSD_BATCH
                 / 1e9, nbytes, on, by_on, off, by_off, card), flush=True)
        for path_label, (run, it) in runs.items():
            torch.cuda.reset_peak_memory_stats()
            busy, top = device_time(lambda: run.held(SSD_PROFILE_STEPS), 1,
                                    per=SSD_PROFILE_STEPS)
            peak = torch.cuda.max_memory_allocated() / 1e9
            for feed in ("fed", "held"):
                step = out[(path_label, feed)] = float(
                    np.mean(ms[(path_label, feed)]))
                host = "; ".join(
                    "%s %.3f" % (p, v / (2 * SSD_STEPS) * 1e3)
                    for p, v in clocks[(path_label, feed)].items())
                print("SSD-300 %s step, %s (cuDNN TF32 on): %.3f ms (%s), "
                      "%.1f images/s; bound %.3f ms (%s), %.1f%% of it; "
                      "host ms a step by phase: %s | %s"
                      % (path_label, "fed by ImageDetIter" if feed == "fed"
                         else "one batch held on the card", step,
                         ", ".join("%.3f" % v for v in ms[(path_label, feed)]),
                         SSD_BATCH / step * 1e3, on, by_on,
                         100 * on / step, host, card), flush=True)
            print("SSD-300 %s held step on the card (profiler): %s; per "
                  "step: %s; peak memory %.2f GB | %s"
                  % (path_label, busy_of(busy, out[(path_label, "held")]),
                     top, peak, card), flush=True)
        pace = out[("hybridized", "fed")] / out[("hybridized", "held")]
        print("SSD-300: the iterator alone gives %.1f images/s, the "
              "hybridized step takes %.1f images/s held and %.1f fed (fed "
              "%.2fx held): %s sets the pace | %s"
              % (io_rate, SSD_BATCH / out[("hybridized", "held")] * 1e3,
                 SSD_BATCH / out[("hybridized", "fed")] * 1e3, pace,
                 "the iterator" if pace > CF_PACE else "the card", card),
              flush=True)
        # a held-out image decoded on the kernel and by the CPU's plain loop
        run = runs["eager"][0]
        val = det_iter(mt, held_path, 1, False, seed).next()
        cls_preds, box_preds = run.net(val.data[0].as_in_context(gpu))
    probs = mt.nd.softmax(cls_preds, axis=1)
    before = vision.LAUNCHES["multibox_nms"]
    det = mt.nd.contrib.MultiBoxDetection(
        probs, box_preds, anchors, nms_threshold=SSD_NMS_THRESHOLD).data
    if vision.LAUNCHES["multibox_nms"] != before + 1:
        fail("MultiBoxDetection on the card did not launch multibox_nms")
    want = mt.nd.contrib.MultiBoxDetection(
        probs.as_in_context(cpu), box_preds.as_in_context(cpu),
        anchors.as_in_context(cpu), nms_threshold=SSD_NMS_THRESHOLD).data
    det = det.cpu()
    if det.shape != (1, SSD_ANCHORS, 6) or not torch.isfinite(det).all():
        fail("SSD-300 detections: %s" % (tuple(det.shape),))
    if not torch.equal(det[..., 0], want[..., 0]):
        fail("SSD-300's held-out detections: class ids differ from the "
             "CPU's plain loop")
    check_close("SSD-300 held-out detections", [det], [want], DET_TOL)
    kept = det[0][det[0, :, 0] >= 0]
    print("SSD-300 held-out image: %d detections kept by multibox_nms, equal "
          "to the CPU's plain loop (class ids; floats within %g); top %s; "
          "the image's objects %s"
          % (kept.shape[0], DET_TOL["atol"],
             np.round(kept[:3].numpy(), 3).tolist(),
             np.round(val.label[0].asnumpy()[0], 3).tolist()), flush=True)
    return out


def ssd_phase(mt, seed, card):
    """Phase 17: multibox_nms against its plain version; the MultiBox ops
    on the card against the CPU; then the main path, counted from 0:
    train_ssd_toy.py's main and SSD-300 on the card. Returns (ms a step by
    (path, feed), launches of multibox_nms on the main path, the kernel's
    largest error, its timing by batch)."""
    import tempfile
    from mxtpu_torch.ops import vision
    t_phase = time.time()
    rng = np.random.RandomState(seed)
    err, timing = nms_kernel_phase(mt, vision, rng, card)
    multibox_card_check(mt, rng, card)
    vision.LAUNCHES["multibox_nms"] = 0
    toy_card_phase(mt, card)
    with tempfile.TemporaryDirectory(prefix="ssd_records_") as workdir:
        ms = ssd300_phase(mt, vision, seed, card, workdir)
    launches = vision.LAUNCHES["multibox_nms"]
    if launches == 0:
        fail("the SSD path never launched multibox_nms")
    print("SSD phase: %.1f s (%s)" % (time.time() - t_phase, card),
          flush=True)
    return ms, launches, err, timing


# ---------------------------------------------------------------------------
# Phase 18: example/rcnn/train_rcnn_toy.py, the toy Faster R-CNN: an RPN
# Group of SoftmaxOutput, MakeLoss and BlockGrad trained through
# simple_bind, then Proposal (its NMS on multibox_nms),
# get_internals()["feat_output"], ROIPooling and an roi head; and Proposal
# at Faster R-CNN's size. The example imports mxtpu, so its main is
# mirrored here for either package.
# ---------------------------------------------------------------------------

RCNN_HW, RCNN_STRIDE, RCNN_SCALES, RCNN_RATIOS = 32, 4, (4,), (1.0,)
RCNN_FEAT = RCNN_HW // RCNN_STRIDE
RCNN_A = len(RCNN_SCALES) * len(RCNN_RATIOS)
RCNN_N, RCNN_BATCH, RCNN_EPOCHS, RCNN_HEAD_STEPS, RCNN_LR = 64, 8, 8, 60, 0.01
RCNN_INPUTS = ("data", "rpn_cls_label", "bbox_target", "bbox_weight")
RCNN_PROPOSAL = dict(rpn_pre_nms_top_n=32, rpn_post_nms_top_n=8,
                     threshold=0.7, rpn_min_size=4, scales=RCNN_SCALES,
                     ratios=RCNN_RATIOS, feature_stride=RCNN_STRIDE)
# the example's three asserts
RCNN_MIN_RPN_ACC, RCNN_MIN_RECALL, RCNN_MIN_HEAD_ACC = 0.9, 0.75, 0.85
# the RPN's first steps on the card (TF32 off) against the CPU's from the
# same weights: each step's objectness cross-entropy and box loss, as
# SSD_TOY_TOL holds the SSD toy's (Adam moves a weight by about lr whatever
# its gradient's size, so the losses and not the weights are held)
RCNN_TOL = dict(rtol=1e-4, atol=1e-6)
# Proposal on the card against the CPU on the same inputs: the same rois
# kept in the same order; their corners (pixels of a 32x32 image) come
# from exp and products that may round differently on the card
RCNN_ROI_TOL = dict(rtol=0, atol=1e-4)

# Proposal at Faster R-CNN's size (VGG16 at stride 16 on a 600x1000
# image: a 38x63 map) with the op's defaults: scales (4, 8, 16, 32) and
# ratios (0.5, 1, 2), 12 anchors a cell, 28,728 in all; 6,000 before the
# NMS, 300 after, threshold 0.7
FRCNN_MAP, FRCNN_IM, FRCNN_CELL_ANCHORS = (38, 63), (600, 1000), 12
FRCNN_PROPOSAL = dict(rpn_pre_nms_top_n=6000, rpn_post_nms_top_n=300,
                      threshold=0.7, feature_stride=16)


def rcnn_images(n, seed=0):
    """train_rcnn_toy.py's make_images: one bright square an image, and
    its box (x1, y1, x2, y2)."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 0.3, (n, 1, RCNN_HW, RCNN_HW)).astype("f")
    boxes = np.zeros((n, 4), "f")
    for i in range(n):
        size = rng.randint(12, 18)
        r0 = rng.randint(0, RCNN_HW - size)
        c0 = rng.randint(0, RCNN_HW - size)
        x[i, 0, r0:r0 + size, c0:c0 + size] += 0.7
        boxes[i] = (c0, r0, c0 + size - 1, r0 + size - 1)
    return x, boxes


def rcnn_anchors():
    """train_rcnn_toy.py's all_anchors: the Proposal op's grid."""
    base = float(RCNN_STRIDE)
    ctr = (base - 1) / 2
    side = base * RCNN_SCALES[0]
    cells = []
    for r in range(RCNN_FEAT):
        for c in range(RCNN_FEAT):
            cx, cy = c * base + ctr, r * base + ctr
            cells.append([cx - side / 2, cy - side / 2,
                          cx + side / 2, cy + side / 2])
    return np.asarray(cells, "f")


def rcnn_iou(boxes, gt):
    """train_rcnn_toy.py's iou of each box with ``gt``."""
    x1 = np.maximum(boxes[:, 0], gt[0])
    y1 = np.maximum(boxes[:, 1], gt[1])
    x2 = np.minimum(boxes[:, 2], gt[2])
    y2 = np.minimum(boxes[:, 3], gt[3])
    inter = np.clip(x2 - x1 + 1, 0, None) * np.clip(y2 - y1 + 1, 0, None)
    area_b = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    area_g = (gt[2] - gt[0] + 1) * (gt[3] - gt[1] + 1)
    return inter / (area_b + area_g - inter)


def rcnn_targets(boxes):
    """train_rcnn_toy.py's rpn_targets: each anchor's label (1 object, 0
    background, -1 ignored), box deltas and regression mask."""
    anchors = rcnn_anchors()
    n = boxes.shape[0]
    labels = np.zeros((n, RCNN_A * RCNN_FEAT * RCNN_FEAT), "f")
    deltas = np.zeros((n, RCNN_A * 4, RCNN_FEAT, RCNN_FEAT), "f")
    for i in range(n):
        ious = rcnn_iou(anchors, boxes[i])
        lab = -np.ones(anchors.shape[0], "f")
        lab[ious < 0.3] = 0.0
        lab[ious >= 0.5] = 1.0
        lab[np.argmax(ious)] = 1.0
        labels[i] = lab
        aw = anchors[:, 2] - anchors[:, 0] + 1
        ah = anchors[:, 3] - anchors[:, 1] + 1
        acx = anchors[:, 0] + aw / 2
        acy = anchors[:, 1] + ah / 2
        gw = boxes[i, 2] - boxes[i, 0] + 1
        gh = boxes[i, 3] - boxes[i, 1] + 1
        gcx = boxes[i, 0] + gw / 2
        gcy = boxes[i, 1] + gh / 2
        d = np.stack([(gcx - acx) / aw, (gcy - acy) / ah,
                      np.log(gw / aw) * np.ones_like(aw),
                      np.log(gh / ah) * np.ones_like(ah)], 1)
        d[lab != 1.0] = 0.0
        deltas[i] = d.reshape(RCNN_FEAT, RCNN_FEAT, RCNN_A * 4) \
            .transpose(2, 0, 1)
    weights = (labels == 1.0).astype("f").reshape(-1, RCNN_FEAT, RCNN_FEAT,
                                                  RCNN_A)
    weights = np.repeat(weights.transpose(0, 3, 1, 2), 4, axis=1)
    return labels, deltas, weights


def rcnn_rpn_symbol(pkg):
    """train_rcnn_toy.py's get_rpn_symbol in either package, in a fresh
    name scope: Group([SoftmaxOutput(multi_output, use_ignore),
    MakeLoss(smooth_l1), BlockGrad(bbox)])."""
    sym = pkg.sym
    with pkg.name.NameManager():
        body = sym.var("data")
        for i, ch in enumerate((16, 32)):
            body = sym.Convolution(body, num_filter=ch, kernel=(3, 3),
                                   pad=(1, 1), name="conv%d" % i)
            body = sym.Activation(body, act_type="relu")
            body = sym.Pooling(body, kernel=(2, 2), stride=(2, 2),
                               pool_type="max")
        feat = sym.Convolution(body, num_filter=32, kernel=(3, 3),
                               pad=(1, 1), name="rpn_conv")
        feat = sym.Activation(feat, act_type="relu", name="feat")
        cls = sym.Convolution(feat, num_filter=2 * RCNN_A, kernel=(1, 1),
                              name="rpn_cls_score")
        cls = sym.Reshape(cls, shape=(0, 2, -1))
        cls_out = sym.SoftmaxOutput(cls, multi_output=True, use_ignore=True,
                                    ignore_label=-1, name="rpn_cls")
        bbox = sym.Convolution(feat, num_filter=4 * RCNN_A, kernel=(1, 1),
                               name="rpn_bbox_pred")
        bbox_tgt = sym.var("bbox_target")
        bbox_w = sym.var("bbox_weight")
        bbox_loss = sym.MakeLoss(
            sym.smooth_l1(bbox_w * (bbox - bbox_tgt), scalar=3.0),
            grad_scale=1.0, name="rpn_bbox_loss")
        return sym.Group([cls_out, bbox_loss, sym.BlockGrad(bbox)])


def rcnn_losses(outs, labels):
    """One RPN step's (objectness cross-entropy over the labelled anchors,
    box loss an image) from the Group's outputs."""
    probs = outs[0].asnumpy()
    b, a = np.nonzero(labels >= 0)
    p = probs[b, labels[b, a].astype(np.int64), a]
    return (float(-np.log(p).mean()),
            float(outs[1].asnumpy().sum() / labels.shape[0]))


def rcnn_toy_main(pkg, ctx, weights=None, max_steps=None):
    """train_rcnn_toy.py's main, line for line, in either package on
    ``ctx``: stage 1 trains the RPN Group through simple_bind (Xavier,
    Adam 0.01, 8 epochs of batch 8), stage 2 runs Proposal on its
    outputs, get_internals()["feat_output"], ROIPooling and the roi head
    (60 Adam steps). ``weights`` ({name: numpy}) replace the RPN's Xavier
    draws (the packages draw differently); ``max_steps`` stops stage 1
    early and skips the head. Returns {"steps": [(objectness
    cross-entropy, box loss)] a step, "rpn_acc", "probs", "bbox_pred",
    "im_info", "rois", "recall", "feat", "pooled", "head_acc" (None with
    ``max_steps``)}."""
    mx = pkg
    hw, feat_hw, a, bsz = RCNN_HW, RCNN_FEAT, RCNN_A, RCNN_BATCH
    with ctx:
        np.random.seed(0)
        mx.random.seed(0)
        n = RCNN_N
        x, boxes = rcnn_images(n)
        labels, deltas, bbox_weights = rcnn_targets(boxes)

        # stage 1: train the RPN
        sym = rcnn_rpn_symbol(mx)
        exe = sym.simple_bind(ctx, grad_req="write", data=(bsz, 1, hw, hw),
                              rpn_cls_label=(bsz, a * feat_hw * feat_hw),
                              bbox_target=(bsz, 4 * a, feat_hw, feat_hw),
                              bbox_weight=(bsz, 4 * a, feat_hw, feat_hw))
        init = mx.init.Xavier()
        for name, arr in exe.arg_dict.items():
            if name not in RCNN_INPUTS:
                init(mx.init.InitDesc(name), arr)
        for name, value in (weights or {}).items():
            exe.arg_dict[name][:] = value
        opt = mx.optimizer.Adam(learning_rate=RCNN_LR)
        states = {k: opt.create_state(i, exe.arg_dict[k])
                  for i, k in enumerate(exe.grad_dict)}
        steps = []
        for epoch in range(RCNN_EPOCHS):
            for b in range(0, n, bsz):
                if len(steps) == max_steps:
                    break
                exe.arg_dict["data"][:] = x[b:b + bsz]
                exe.arg_dict["rpn_cls_label"][:] = labels[b:b + bsz]
                exe.arg_dict["bbox_target"][:] = deltas[b:b + bsz]
                exe.arg_dict["bbox_weight"][:] = bbox_weights[b:b + bsz]
                outs = exe.forward(is_train=True)
                exe.backward()
                for i, (k, g) in enumerate(exe.grad_dict.items()):
                    if g is not None and k not in RCNN_INPUTS:
                        opt.update(i, exe.arg_dict[k], g, states[k])
                steps.append(rcnn_losses(outs, labels[b:b + bsz]))

        # RPN objectness accuracy on labelled anchors
        exe.arg_dict["data"][:] = x[:bsz]
        exe.arg_dict["rpn_cls_label"][:] = labels[:bsz]
        exe.arg_dict["bbox_target"][:] = deltas[:bsz]
        exe.arg_dict["bbox_weight"][:] = bbox_weights[:bsz]
        probs = exe.forward(is_train=False)[0].asnumpy()
        pred = probs.argmax(axis=1)
        mask = labels[:bsz] >= 0
        rpn_acc = float((pred[mask] == labels[:bsz][mask]).mean())

        # stage 2: Proposal + ROIPooling + roi head
        cls_prob = mx.nd.array(probs.reshape(bsz, 2 * a, feat_hw, feat_hw))
        bbox_pred = mx.nd.array(exe.outputs[2].asnumpy().reshape(
            bsz, 4 * a, feat_hw, feat_hw))
        im_info = np.tile([hw, hw, 1.0], (bsz, 1)).astype("f")
        rois = mx.nd.Proposal(cls_prob, bbox_pred, mx.nd.array(im_info),
                              **RCNN_PROPOSAL)
        rois_np = rois.asnumpy()
        recalls = []
        for i in range(bsz):
            mine = rois_np[rois_np[:, 0] == i][:, 1:]
            recalls.append(rcnn_iou(mine, boxes[i]).max() if len(mine)
                           else 0.0)
        recall = float(np.mean([r > 0.5 for r in recalls]))

        feat_sym = sym.get_internals()["feat_output"]
        feat_exe = feat_sym.simple_bind(ctx, grad_req="null",
                                        data=(bsz, 1, hw, hw))
        feat_exe.copy_params_from(
            {k: v for k, v in exe.arg_dict.items()
             if k in feat_exe.arg_dict and k != "data"}, {})
        feat_exe.arg_dict["data"][:] = x[:bsz]
        feat = feat_exe.forward(is_train=False)[0]
        pooled = mx.nd.ROIPooling(feat, rois, pooled_size=(4, 4),
                                  spatial_scale=1.0 / RCNN_STRIDE)
        out = {"steps": steps, "rpn_acc": rpn_acc, "probs": probs,
               "bbox_pred": bbox_pred.asnumpy(), "im_info": im_info,
               "rois": rois_np, "recall": recall, "feat": feat.asnumpy(),
               "pooled": pooled.asnumpy(), "head_acc": None}
        if max_steps is not None:
            return out
        roi_labels = np.zeros((rois_np.shape[0],), "f")
        for j in range(rois_np.shape[0]):
            i = int(rois_np[j, 0])
            roi_labels[j] = 1.0 if rcnn_iou(rois_np[j:j + 1, 1:],
                                            boxes[i])[0] > 0.5 else 0.0
        head = mx.sym.var("pooled")
        head_net = mx.sym.FullyConnected(mx.sym.Flatten(head), num_hidden=32,
                                         name="head_fc1")
        head_net = mx.sym.Activation(head_net, act_type="relu")
        head_net = mx.sym.FullyConnected(head_net, num_hidden=2,
                                         name="head_fc2")
        head_net = mx.sym.SoftmaxOutput(head_net, name="cls")
        hexe = head_net.simple_bind(ctx, grad_req="write",
                                    pooled=tuple(pooled.shape),
                                    cls_label=(pooled.shape[0],))
        for name, arr in hexe.arg_dict.items():
            if name not in ("pooled", "cls_label"):
                init(mx.init.InitDesc(name), arr)
        hopt = mx.optimizer.Adam(learning_rate=RCNN_LR)
        hstates = {k: hopt.create_state(i, hexe.arg_dict[k])
                   for i, k in enumerate(hexe.grad_dict)}
        hexe.arg_dict["pooled"][:] = pooled
        hexe.arg_dict["cls_label"][:] = roi_labels
        for step in range(RCNN_HEAD_STEPS):
            hexe.forward(is_train=True)
            hexe.backward()
            for i, (k, g) in enumerate(hexe.grad_dict.items()):
                if g is not None and k not in ("pooled", "cls_label"):
                    hopt.update(i, hexe.arg_dict[k], g, hstates[k])
        pred = hexe.forward(is_train=False)[0].asnumpy().argmax(axis=1)
        out["head_acc"] = float((pred == roi_labels).mean())
        return out


def rcnn_phase(mt, vision, card):
    """Phase 18: train_rcnn_toy.py's main on gpu(0), multibox_nms counted
    from 0 just before it: the example's three asserts, its first 3 RPN
    steps against the CPU's (RCNN_TOL), one kernel launch for its one
    Proposal call, and its rois and pooled features against the CPU's
    Proposal and ROIPooling on the same inputs. Returns the launches."""
    cpu, gpu = mt.cpu(), mt.gpu(0)
    want = rcnn_toy_main(mt, cpu, max_steps=FIT_STEPS)["steps"]
    vision.LAUNCHES["multibox_nms"] = 0
    t0 = time.perf_counter()
    run = rcnn_toy_main(mt, gpu)
    secs = time.perf_counter() - t0
    launches = vision.LAUNCHES["multibox_nms"]
    if launches != 1:
        fail("the R-CNN toy's one Proposal call launched multibox_nms %d "
             "times" % launches)
    got = run["steps"][:FIT_STEPS]
    if not np.allclose(got, want, **RCNN_TOL):
        fail("the R-CNN toy's first %d RPN steps on the card %s, on the CPU "
             "%s (%s)" % (FIT_STEPS, got, want, RCNN_TOL))
    for what, value, ok, limit in (
            ("RPN objectness accuracy", run["rpn_acc"],
             run["rpn_acc"] > RCNN_MIN_RPN_ACC, "> %g" % RCNN_MIN_RPN_ACC),
            ("proposal recall@0.5", run["recall"],
             run["recall"] >= RCNN_MIN_RECALL, ">= %g" % RCNN_MIN_RECALL),
            ("roi head accuracy", run["head_acc"],
             run["head_acc"] > RCNN_MIN_HEAD_ACC,
             "> %g" % RCNN_MIN_HEAD_ACC)):
        if not ok:
            fail("the R-CNN toy on gpu(0): %s %.3f (the example asserts %s)"
                 % (what, value, limit))
    nd = mt.nd
    with cpu:
        rois = nd.Proposal(
            nd.array(run["probs"].reshape(run["bbox_pred"].shape[0], -1,
                                          RCNN_FEAT, RCNN_FEAT)),
            nd.array(run["bbox_pred"]), nd.array(run["im_info"]),
            **RCNN_PROPOSAL).asnumpy()
        pooled = nd.ROIPooling(nd.array(run["feat"]), nd.array(run["rois"]),
                               pooled_size=(4, 4),
                               spatial_scale=1.0 / RCNN_STRIDE).asnumpy()
    if not np.allclose(run["rois"], rois, **RCNN_ROI_TOL):
        fail("the R-CNN toy's rois on the card differ from the CPU's "
             "Proposal on the same inputs by %g"
             % np.abs(run["rois"] - rois).max())
    if not np.array_equal(run["pooled"], pooled):
        fail("ROIPooling on the card differs from the CPU's by %g"
             % np.abs(run["pooled"] - pooled).max())
    first, last = np.mean(run["steps"][:4], 0), np.mean(run["steps"][-4:], 0)
    print("R-CNN toy (train_rcnn_toy.py's main) on gpu(0): %d RPN steps and "
          "%d head steps in %.2f s; RPN objectness accuracy %.3f (> %g), "
          "proposal recall@0.5 %.3f (>= %g), roi head accuracy %.3f (> %g); "
          "first %d RPN steps' (cross-entropy, box loss) within %s of the "
          "CPU's (largest gap %.3g); first 4 steps' mean (%.4f, %.4f), last "
          "4 steps' (%.4f, %.4f); %d rois within %g px of the CPU's "
          "Proposal (largest gap %.3g), pooled features equal; "
          "multibox_nms launched %d time(s) for 1 Proposal call | %s"
          % (len(run["steps"]), RCNN_HEAD_STEPS, secs, run["rpn_acc"],
             RCNN_MIN_RPN_ACC, run["recall"], RCNN_MIN_RECALL,
             run["head_acc"], RCNN_MIN_HEAD_ACC, FIT_STEPS, RCNN_TOL,
             float(np.abs(np.subtract(got, want)).max()), first[0],
             first[1], last[0], last[1], rois.shape[0],
             RCNN_ROI_TOL["atol"], float(np.abs(run["rois"] - rois).max()),
             launches, card), flush=True)
    return launches


def proposal_size_phase(mt, vision, rng, card):
    """Phase 18b: Proposal at Faster R-CNN's size on gpu(0): one image of
    600x1000 at stride 16, random objectness and small deltas from
    ``rng``. Its rois equal those of the same op with the NMS on the
    plain loop on the card. Then multibox_nms at the shape the op gave
    it (6,000 rows, one class) timed beside its bound, the plain loop
    beside it. Returns (ms, plain ms, bound ms, bound by)."""
    import torch
    nd, gpu = mt.nd, mt.gpu(0)
    h, w = FRCNN_MAP
    fg = rng.uniform(0, 1, (1, FRCNN_CELL_ANCHORS, h, w)).astype(np.float32)
    inputs = [nd.array(v, ctx=gpu) for v in (
        np.concatenate([1 - fg, fg], 1),
        (0.1 * rng.standard_normal((1, 4 * FRCNN_CELL_ANCHORS, h, w)))
        .astype(np.float32),
        np.array([[FRCNN_IM[0], FRCNN_IM[1], 1.0]], np.float32))]
    kernel, calls = vision.multibox_nms, []

    def recorded(*args):
        calls.append(args)
        return kernel(*args)
    rois = {}
    for name, nms in (("kernel", recorded),
                      ("plain", vision.multibox_nms_plain)):
        vision.multibox_nms = nms
        try:
            rois[name] = nd.Proposal(*inputs, **FRCNN_PROPOSAL).data
        finally:
            vision.multibox_nms = kernel
    torch.cuda.synchronize()
    if len(calls) != 1:
        fail("Proposal made %d NMS calls, not 1" % len(calls))
    if not torch.equal(rois["kernel"], rois["plain"]):
        fail("Proposal at %dx%d: %d of %d roi values differ between "
             "multibox_nms and its plain loop on the card"
             % (FRCNN_IM + (int((rois["kernel"] != rois["plain"]).sum()),
                            rois["kernel"].numel())))
    boxes, cls_id, threshold, force, limit = calls[0]
    anchors = FRCNN_CELL_ANCHORS * h * w
    ms = cuda_ms(lambda: kernel(boxes, cls_id, threshold, force, limit),
                 iters=20)
    plain_ms = cuda_ms(lambda: vision.multibox_nms_plain(
        boxes, cls_id, threshold, force, limit), iters=1, warmup=0)
    kept = int((kernel(boxes, cls_id, threshold, force, limit) >= 0).sum())
    pairs = nms_pairs(vision, cls_id, boxes, force, limit, threshold)
    ops_ms = pairs * NMS_PAIR_OPS / PEAK_F32 * 1e3
    bytes_ms = cls_id.numel() * (16 + 4 + 4) / PEAK_BYTES_S * 1e3
    bound, by = (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")
    print("Proposal at Faster R-CNN's size (%dx%d image, a %dx%d map at "
          "stride 16, %d anchors, top %d before the NMS, %d after, threshold "
          "%g) on gpu(0): its %d rois equal those of the plain NMS loop on "
          "the card; %d boxes survive the NMS | %s"
          % (FRCNN_IM + FRCNN_MAP + (anchors, limit,
                                     FRCNN_PROPOSAL["rpn_post_nms_top_n"],
                                     threshold, rois["kernel"].shape[0],
                                     kept, card)), flush=True)
    print("time multibox_nms at Proposal's shape (1 x %d rows, one class, "
          "force_suppress): %.4f ms (CUDA events, 20 calls), plain loop %.2f "
          "ms; %d pairs tested; bound %.6f ms (%s), the kernel at %.3f%% of "
          "it; no library call (torch has no NMS) | %s"
          % (limit, ms, plain_ms, pairs, bound, by, 100 * bound / ms, card),
          flush=True)
    return ms, plain_ms, bound, by


# ---------------------------------------------------------------------------
# Phase 19: multi-output graphs through Module.fit:
# example/python-howto/multiple_outputs.py and
# example/multi-task/multitask_mnist.py (a Group of two SoftmaxOutput heads,
# two labels, a custom EvalMetric), mirrored for either package.
# ---------------------------------------------------------------------------

MT_TRAIN, MT_TEST, MT_BATCH, MT_EPOCHS, MT_LR = 2048, 512, 128, 4, 1e-3
MT_LABELS = ("softmax_digit_label", "softmax_parity_label")
MT_MIN_ACC = 0.9                   # the example asserts both heads above
# the first steps' cross-entropies of both heads, card vs CPU (Adam: the
# losses and not the weights are held, as RCNN_TOL)
MT_TOL = dict(rtol=1e-4, atol=1e-6)
MT_TIMED_EPOCHS = 2


def multitask_digits(n, seed=0):
    """multitask_mnist.py's synthetic_digits: fixed class prototypes plus
    noise of ``seed``."""
    protos = np.random.RandomState(0).uniform(0, 1, (10, 784)) \
        .astype(np.float32)
    r = np.random.RandomState(seed)
    y = r.randint(0, 10, n)
    x = protos[y] + 0.25 * r.randn(n, 784).astype(np.float32)
    return x.astype(np.float32), y.astype(np.float32)


def multitask_symbol(pkg):
    """multitask_mnist.py's build(): 784 -> 128 relu -> {10, 2} softmax
    heads, grouped."""
    sym = pkg.sym
    with pkg.name.NameManager():
        shared = sym.FullyConnected(sym.var("data"), name="fc1",
                                    num_hidden=128)
        shared = sym.Activation(shared, name="relu1", act_type="relu")
        digit = sym.SoftmaxOutput(sym.FullyConnected(
            shared, name="fc_digit", num_hidden=10), name="softmax_digit")
        parity = sym.SoftmaxOutput(sym.FullyConnected(
            shared, name="fc_parity", num_hidden=2), name="softmax_parity")
        return sym.Group([digit, parity])


def multi_accuracy(pkg, num=2):
    """multitask_mnist.py's MultiAccuracy: accuracy a head, read on the
    host (no device rule)."""

    class MultiAccuracy(pkg.metric.EvalMetric):
        def __init__(self, num=2):
            self.num = num
            super().__init__("multi-accuracy")

        def reset(self):
            self.num_inst = [0] * self.num
            self.sum_metric = [0.0] * self.num

        def update(self, labels, preds):
            for i in range(self.num):
                pred = preds[i].asnumpy().argmax(axis=1)
                label = labels[i].asnumpy().astype(np.int64)
                self.sum_metric[i] += float((pred == label).sum())
                self.num_inst[i] += len(label)

        def get(self):
            accs = [s / max(n, 1) for s, n in zip(self.sum_metric,
                                                  self.num_inst)]
            return (["digit-acc", "parity-acc"], accs)

    return MultiAccuracy(num)


def multitask_iters(pkg, n_train=MT_TRAIN, shuffle=True):
    """multitask_mnist.py's iterators (shuffle from numpy's global
    stream)."""
    xtr, ytr = multitask_digits(n_train, seed=0)
    xte, yte = multitask_digits(MT_TEST, seed=1)
    train = pkg.io.NDArrayIter(
        xtr, {MT_LABELS[0]: ytr, MT_LABELS[1]: (ytr % 2).astype(np.float32)},
        MT_BATCH, shuffle=shuffle)
    val = pkg.io.NDArrayIter(
        xte, {MT_LABELS[0]: yte, MT_LABELS[1]: (yte % 2).astype(np.float32)},
        MT_BATCH)
    return train, val


def multitask_module(pkg, context=None):
    where = {} if context is None else {"context": context}
    return pkg.mod.Module(multitask_symbol(pkg), data_names=("data",),
                          label_names=MT_LABELS, **where)


def multitask_fit(pkg, context=None, num_epoch=MT_EPOCHS):
    """multitask_mnist.py's main through Module.fit in either package (its
    seeds, iterators, Adam 1e-3, MultiAccuracy), on the current context
    unless ``context``; then the example's scoring loop. Returns (module,
    train, validation, [digit accuracy, parity accuracy])."""
    np.random.seed(0)
    pkg.random.seed(11)
    train, val = multitask_iters(pkg)
    mod = multitask_module(pkg, context)
    mod.fit(train, eval_data=val, optimizer="adam",
            optimizer_params={"learning_rate": MT_LR},
            eval_metric=multi_accuracy(pkg), num_epoch=num_epoch)
    metric = multi_accuracy(pkg)
    metric.reset()
    val.reset()
    for batch in val:
        mod.forward(batch, is_train=False)
        metric.update(batch.label, mod.get_outputs())
    return mod, train, val, metric.get()[1]


def multitask_init_params(pkg, seed):
    """The multitask net's weights as Module draws them by default, from
    ``seed`` on the CPU; {name: numpy}."""
    pkg.random.seed(seed)
    mod = multitask_module(pkg, pkg.cpu())
    train, _ = multitask_iters(pkg, shuffle=False)
    mod.bind(train.provide_data, train.provide_label)
    mod.init_params()
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def multitask_first_steps(pkg, context, arg_params, steps=FIT_STEPS):
    """The example's first ``steps`` Module steps (its shuffled batches,
    Adam 1e-3) from ``arg_params`` on ``context``: each step's
    cross-entropy of the digit head and of the parity head."""
    np.random.seed(0)
    pkg.random.seed(11)
    train, _ = multitask_iters(pkg)
    mod = multitask_module(pkg, context)
    mod.bind(train.provide_data, train.provide_label)
    mod.init_params(arg_params=host_params(pkg, arg_params))
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": MT_LR})
    losses = []
    for _ in range(steps):
        batch = train.next()
        mod.forward_backward(batch)
        mod.update()
        losses.append(tuple(
            float(-np.log(o.asnumpy()[np.arange(o.shape[0]),
                                      lab.asnumpy().astype(np.int64)]).mean())
            for o, lab in zip(mod.get_outputs(), batch.label)))
    return losses


def multiple_outputs_main(pkg, ctx):
    """example/python-howto/multiple_outputs.py's main on ``ctx``: a Group
    of fc, relu(fc) and BlockGrad(relu), bound by simple_bind, read from
    one forward; the example's checks. Returns (the executor, its list of
    outputs, the outputs as numpy)."""
    sym = pkg.sym
    with pkg.name.NameManager():
        data = sym.Variable("data")
        fc = sym.FullyConnected(data, num_hidden=8, name="fc")
        act = sym.Activation(fc, act_type="relu", name="relu")
        out = sym.Group([fc, act, sym.BlockGrad(act)])
    if len(out.list_outputs()) != 3:
        fail("multiple_outputs: %s" % out.list_outputs())
    ex = out.simple_bind(ctx, data=(2, 4))
    r = np.random.RandomState(0)
    ex.arg_dict["data"][:] = r.randn(2, 4).astype("f")
    for k, v in ex.arg_dict.items():
        if k != "data":
            v[:] = r.uniform(-1, 1, v.shape).astype("f")
    fc_o, act_o, blocked = [o.asnumpy() for o in ex.forward()]
    if not (np.allclose(act_o, np.maximum(fc_o, 0), rtol=1e-6)
            and np.allclose(blocked, act_o, rtol=1e-6)):
        fail("multiple_outputs on %s: relu or BlockGrad output wrong" % ctx)
    return ex, out.list_outputs(), [fc_o, act_o, blocked]


def fused_report(mod):
    """The fused trainer's engagement as text: captures, replays, steps
    and fallbacks, or why it did not engage."""
    trainer = mod._fused
    if trainer is None:
        return "fused step not engaged: %s" % getattr(
            mod, "_fused_fallback_logged", "disabled after a fallback")
    stats = trainer._group.stats
    entries = trainer._cache.entries()
    return ("fused step engaged: %d steps, %d signatures, %d graphs "
            "captured, %d replays, %d fallbacks"
            % (stats["steps"], len(entries),
               sum(e.graph is not None for e in entries),
               sum(e.replays for e in entries), stats["fallbacks"]))


def multi_output_phase(mt, seed, card):
    """Phase 19: multiple_outputs.py on gpu(0) against the CPU (outputs,
    and the gradients of a backward with the implicit head gradients:
    none through BlockGrad); the multitask net's first 3 Module steps on
    the card, eager and fused, against the CPU's; its fit eager and as
    fit makes it by default, both heads above MT_MIN_ACC, the fused
    trainer's engagement printed; then the cost of MultiAccuracy's host
    reads against a metric accumulated on the card. Returns {path: ms a
    step}."""
    import torch
    gpu, cpu = mt.gpu(0), mt.cpu()
    exes = {}
    for ctx in (gpu, cpu):
        ex, names, outs = multiple_outputs_main(mt, ctx)
        ex.forward(is_train=True)
        ex.backward()
        exes[ctx] = (names, outs, {k: g.asnumpy()
                                   for k, g in ex.grad_dict.items()})
    (names, outs, grads), (names_c, outs_c, grads_c) = exes[gpu], exes[cpu]
    if names != names_c or not all(np.allclose(a, b, **FIT_TOL) for a, b in
                                   zip(outs + list(grads.values()),
                                       outs_c + list(grads_c.values()))):
        fail("multiple_outputs on gpu(0) differs from the CPU")
    print("multiple_outputs.py on gpu(0): outputs %s equal the CPU's within "
          "%s, relu and BlockGrad checks hold; backward with the implicit "
          "head gradients: fc_bias's gradient %s (fc's ones plus relu's, "
          "none through BlockGrad), equal to the CPU's"
          % (names, FIT_TOL, np.round(grads["fc_bias"], 3).tolist()),
          flush=True)

    p0 = multitask_init_params(mt, seed)
    want = multitask_first_steps(mt, cpu, p0)
    for fused in (False, True):
        got = with_fused(fused, multitask_first_steps, mt, gpu, p0)
        if not np.allclose(got, want, **MT_TOL):
            fail("the multitask net's first %d steps on the card (%s) %s, on "
                 "the CPU %s (%s)" % (FIT_STEPS, "fused" if fused else
                                      "eager", got, want, MT_TOL))
        print("multitask net: %d Module steps on the card (%s) against the "
              "CPU's: (digit, parity) cross-entropies %s, largest gap %.3g "
              "(%s)" % (FIT_STEPS, "fused" if fused else "eager",
                        ", ".join("(%.5f, %.5f)" % g for g in got),
                        float(np.abs(np.subtract(got, want)).max()), MT_TOL),
              flush=True)

    runs = {}
    for label, fused in (("eager", False), ("default", True)):
        t0 = time.perf_counter()
        mod, train, val, accs = with_fused(fused, multitask_fit, mt)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if mod._context != [gpu]:
            fail("the multitask Module's context is %s" % mod._context)
        if not (accs[0] > MT_MIN_ACC and accs[1] > MT_MIN_ACC):
            fail("multitask_mnist.py's fit on gpu(0) (%s): accuracies %s "
                 "(the example asserts > %g)" % (label, accs, MT_MIN_ACC))
        if fused and mod._fused is None:
            fail("the multitask fit did not engage the fused step, where "
                 "mxtpu's predicate does: %s" % fused_report(mod))
        print("multitask_mnist.py's fit on gpu(0), %s (MXTPU_MODULE_FUSED=%d):"
              " %d epochs in %.2f s; digit accuracy %.4f, parity %.4f (> %g);"
              " %s | %s" % (label, fused, MT_EPOCHS, secs, accs[0], accs[1],
                            MT_MIN_ACC, fused_report(mod), card), flush=True)
        runs[label] = (mod, train)

    # MultiAccuracy reads both heads' outputs on the host every step; the
    # same fit's steps with Accuracy, summed on the card, in turns
    mod, train = runs["default"]
    metrics = {"MultiAccuracy": multi_accuracy(mt),
               "Accuracy": mt.metric.Accuracy()}
    ms = {k: [] for k in metrics}
    for k in metrics:
        fit_epoch(mod, train, metrics[k])
    for k in ("MultiAccuracy", "Accuracy", "Accuracy", "MultiAccuracy"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = sum(fit_epoch(mod, train, metrics[k])
                    for _ in range(MT_TIMED_EPOCHS))
        torch.cuda.synchronize()
        ms[k].append((time.perf_counter() - t0) / steps * 1e3)
    out = {k: float(np.mean(v)) for k, v in ms.items()}
    print("multitask fused step with MultiAccuracy (host reads of both "
          "outputs a step) %.3f ms (%s), with Accuracy on the card %.3f ms "
          "(%s): the host reads cost %.3f ms a step; %s | %s"
          % (out["MultiAccuracy"], ", ".join("%.3f" % v for v in
                                               ms["MultiAccuracy"]),
             out["Accuracy"], ", ".join("%.3f" % v for v in ms["Accuracy"]),
             out["MultiAccuracy"] - out["Accuracy"], fused_report(mod),
             card), flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 20: the data files at MNIST's published size (60,000 training and
# 10,000 test images, idx.gz as example/utils/get_data.py's get_mnist writes
# them, from --seed): LeNet (BASELINE.json config 1) through Module.fit fed
# by MNISTIter, eager and captured; the hybridized MLP of
# example/gluon/mnist.py fed by gluon.data.vision.MNIST, transforms and a
# DataLoader; CIFAR10's 10,000 test images (python pickles) through a
# DataLoader; one epoch of CSVIter and LibSVMIter
# ---------------------------------------------------------------------------

MN_TRAIN, MN_TEST, MN_BATCH = 60000, 10000, 64
# example/gluon/mnist.py's MLP fed by vision.MNIST must reach this test
# accuracy after one epoch: the classes are get_mnist's fixed prototypes
# under noise (the port reaches 1.0 on the CPU at 2,000 images)
MN_GLUON_MIN_ACC = 0.98
MN_GLUON_OPT = {"learning_rate": 0.1, "momentum": 0.9}
MN_WORKERS = 2                     # the DataLoader's threads, as phase 15's
# the loader alone in the caller's thread (no workers), over this many
# batches: whether the worker threads help a host-bound loader
MN_SERIAL_BATCHES = 40
# the Gluon MLP's fed run: this many batches (of an epoch's 937); the
# loader alone, with its threads and in the caller's: MN_LOADER_BATCHES
MN_GLUON_STEPS = 60
MN_LOADER_BATCHES = 40
MN_TIMED_STEPS, MN_PROFILE_STEPS = 25, 4
# the fed step against the held one: the iterator sets the pace beyond this
MN_PACE = 1.05
CIFAR_TEST, CIFAR_BATCH = 10000, 128
FILE_ROWS = 2000                   # CSV and LibSVM rows (MNIST test images)


def write_idx(path, array, magic):
    """An idx.gz file as get_data.py's _write_idx_* write it."""
    import gzip
    import struct
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">%dI" % (array.ndim + 1), magic,
                            *array.shape))
        f.write(array.astype(np.uint8).tobytes())


def mnist_files(root, seed, n_train, n_test):
    """get_data.py's get_mnist under ``root`` from ``seed``: ten fixed
    28x28 prototypes in [0, 160) plus N(0, 24) noise, clipped to [0,
    255], labels uniform. Returns the (images, labels) paths a split."""
    rng = np.random.RandomState(seed)
    protos = rng.uniform(0, 160, (10, 28, 28))
    paths = {}
    for split, n, img, lbl in (
            ("train", n_train, "train-images-idx3-ubyte.gz",
             "train-labels-idx1-ubyte.gz"),
            ("test", n_test, "t10k-images-idx3-ubyte.gz",
             "t10k-labels-idx1-ubyte.gz")):
        labels = rng.randint(0, 10, n)
        images = np.clip(protos[labels] + rng.normal(0, 24, (n, 28, 28)),
                         0, 255)
        paths[split] = (os.path.join(root, img), os.path.join(root, lbl))
        write_idx(paths[split][0], images, 2051)
        write_idx(paths[split][1], labels, 2049)
    return paths


def cifar_pickles(root, seed, n_test):
    """CIFAR-10's test batch as the python pickle of
    ``cifar-10-batches-py/test_batch`` (rows of 3 x 32 x 32 uint8,
    channel-major, and a list of labels), from ``seed``: each class a
    mean colour under noise, as get_data.py's get_cifar10 draws them."""
    import pickle
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, n_test)
    data = np.clip(rng.normal(100 + 12 * labels[:, None], 40,
                              (n_test, 3072)), 0, 255).astype(np.uint8)
    pydir = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(pydir, exist_ok=True)
    with open(os.path.join(pydir, "test_batch"), "wb") as f:
        pickle.dump({"data": data, "labels": labels.tolist()}, f)


def mnist_iters(pkg, paths, batch=MN_BATCH):
    """get_data.py's get_mnist_iters: MNISTIter over the training files
    (shuffled) and the test files."""
    train = pkg.io.MNISTIter(image=paths["train"][0],
                             label=paths["train"][1], batch_size=batch,
                             shuffle=True)
    val = pkg.io.MNISTIter(image=paths["test"][0], label=paths["test"][1],
                           batch_size=batch, shuffle=False)
    return train, val


def mnist_transform(pkg):
    """The samples' transform: ToTensor, then Normalize(0.13, 0.31)."""
    transforms = pkg.gluon.data.vision.transforms
    return transforms.Compose([transforms.ToTensor(),
                               transforms.Normalize(0.13, 0.31)])


def gluon_mlp(pkg, ctx):
    """example/gluon/mnist.py's hybridized MLP (128 relu, 64 relu, 10) with
    Xavier on ``ctx``."""
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="hybridsequential0_")
    net.add(nn.Dense(128, activation="relu"), nn.Dense(64, activation="relu"),
            nn.Dense(10))
    net.initialize(pkg.init.Xavier(), ctx=ctx)
    return net


def gluon_files_accuracy(pkg, net, root, ctx):
    """The MLP's accuracy over vision.MNIST(train=False) through a
    DataLoader."""
    vision = pkg.gluon.data.vision
    loader = pkg.gluon.data.DataLoader(
        vision.MNIST(root, train=False).transform_first(
            mnist_transform(pkg)), batch_size=MN_BATCH * 4)
    metric = pkg.metric.Accuracy()
    with ctx:
        for x, y in loader:
            metric.update([y], [net(x)])
    return metric.get()[1]


def loader_rate(ctx, loader, batches=None):
    """Images/s of ``loader`` alone over one epoch (or its first
    ``batches``), its batches put on ``ctx`` and waited for."""
    import torch
    t0 = time.perf_counter()
    n = 0
    with ctx:
        for i, batch in enumerate(loader):
            if i == batches:
                break
            n += batch[0].shape[0]
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def iter_rate(data_iter):
    """Images/s of one epoch of a DataIter alone (its host batches)."""
    data_iter.reset()
    t0 = time.perf_counter()
    n = sum(b.data[0].shape[0] - (b.pad or 0) for b in data_iter)
    return n / (time.perf_counter() - t0)


def pace_line(label, fed, held, alone, batch, busy, card):
    """Which side sets a fed step's pace, as text printed."""
    pace = "the iterator" if fed > MN_PACE * held else "the card"
    print("%s pace: the step fed %.1f images/s, on one held batch %.1f; the "
          "iterator alone %.1f images/s; the card busy %s ms a fed step: set "
          "by %s (the iterator if the fed step is beyond %.2f of the held "
          "one's) | %s"
          % (label, batch / fed * 1e3, batch / held * 1e3, alone,
             "not measured" if busy is None else "%.3f" % busy, pace,
             MN_PACE, card), flush=True)
    return pace


def lenet_files(mt, paths, card):
    """LeNet through Module.fit fed by MNISTIter at 60,000 images, one
    epoch eager (MXTPU_MODULE_FUSED=0, fit's kvstore="local") and one
    captured, each scored on the 10,000 test images: validation accuracy
    >= LENET_MIN_ACC. Then the iterator alone, and fed_held_times.
    Returns {path: ms a step} and the pace."""
    import torch
    if mt.io.MNISTIter(image=paths["test"][0], label=paths["test"][1],
                       batch_size=MN_BATCH).provide_label[0].name != \
            "softmax_label":
        fail("MNISTIter's label is not named softmax_label")
    runs = {}
    for path, fused in (("eager", False), ("captured", True)):
        iters = mnist_iters(mt, paths)
        np.random.seed(0)
        mt.random.seed(0)
        t0 = time.perf_counter()
        mod = with_fused(fused, lenet_fit, mt, iters, num_epoch=1,
                         kvstore="local")[0]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        acc = dict(mod.score(iters[1], mt.metric.Accuracy()))["accuracy"]
        if not acc >= LENET_MIN_ACC:
            fail("LeNet fed by MNISTIter (%s): validation accuracy %.4f "
                 "(limit %.2f)" % (path, acc, LENET_MIN_ACC))
        if fused != (mod._fused is not None):
            fail("LeNet fed by MNISTIter (%s): %s" % (path, fused_report(mod)))
        print("LeNet through Module.fit fed by MNISTIter (%d images, batch "
              "%d, softmax_label), %s: 1 epoch in %.2f s; validation accuracy "
              "over %d images %.4f (limit %.2f); %s | %s"
              % (MN_TRAIN, MN_BATCH, path, secs, MN_TEST, acc, LENET_MIN_ACC,
                 fused_report(mod), card), flush=True)
        runs[path] = (mod, iters[0])
    alone = iter_rate(mnist_iters(mt, paths)[0])
    print("MNISTIter alone: %.1f images/s (one epoch of %d, host batches) | %s"
          % (alone, MN_TRAIN, card), flush=True)
    times = fed_held_times(mt, runs, "LeNet fed by MNISTIter", card,
                           MN_TIMED_STEPS, MN_PROFILE_STEPS, MN_BATCH,
                           mt.metric.Accuracy)
    pace = pace_line("LeNet fed by MNISTIter", times["captured"][0],
                     times["fixed"][0], alone, MN_BATCH,
                     times["captured"][1], card)
    return {k: v[0] for k, v in times.items()}, pace


def gluon_files(mt, root, card):
    """example/gluon/mnist.py's hybridized MLP on gpu(0) fed by
    vision.MNIST(train=True) through transform_first(ToTensor,
    Normalize(0.13, 0.31)) and a DataLoader (batch 64, shuffle,
    MN_WORKERS threads): one epoch, then its test accuracy above
    MN_GLUON_MIN_ACC; the loader alone; the step fed against the step on
    a held batch in turns, the host's wait for a batch, the card's busy
    share. Returns ({path: ms a step}, the pace)."""
    import torch
    gpu = mt.gpu(0)
    vision = mt.gluon.data.vision
    np.random.seed(0)
    mt.random.seed(0)
    train = vision.MNIST(root, train=True).transform_first(
        mnist_transform(mt))
    sample, label = train[0]
    if sample.context != mt.cpu() or sample.shape != (1, 28, 28):
        fail("vision.MNIST's transformed sample: %s on %s"
             % (sample.shape, sample.context))
    net = gluon_mlp(mt, gpu)
    run = GluonRun(mt, net, train, gpu, MN_BATCH, True, MN_GLUON_OPT,
                   workers=MN_WORKERS, shuffle=True)
    steps = MN_GLUON_STEPS
    t0 = time.perf_counter()
    run.steps(steps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    acc = gluon_files_accuracy(mt, net, root, gpu)
    if not acc > MN_GLUON_MIN_ACC:
        fail("example/gluon/mnist.py fed by vision.MNIST: test accuracy %.4f "
             "(stated before the run: > %.2f)" % (acc, MN_GLUON_MIN_ACC))
    losses = run.loss_values()
    print("example/gluon/mnist.py's MLP hybridized on gpu(0), fed by "
          "vision.MNIST + ToTensor + Normalize through a DataLoader (%d "
          "threads, batch %d, shuffle): %d steps in %.2f s; loss "
          "%.4f -> %.4f; test accuracy over %d images %.4f (> %.2f); %s | %s"
          % (MN_WORKERS, MN_BATCH, steps, secs, np.mean(losses[:10]),
             np.mean(losses[-10:]), MN_TEST, acc, MN_GLUON_MIN_ACC,
             net.cache_stats(), card), flush=True)
    alone = loader_rate(gpu, run.loader, MN_LOADER_BATCHES)
    serial = loader_rate(gpu, mt.gluon.data.DataLoader(
        train, batch_size=MN_BATCH, shuffle=True), MN_SERIAL_BATCHES)
    print("vision.MNIST DataLoader alone (%d threads, transforms on the "
          "host, one pinned copy up a batch): %.1f images/s over %d "
          "batches; in the caller's thread (no workers): %.1f images/s over "
          "%d batches | %s" % (MN_WORKERS, alone, MN_LOADER_BATCHES, serial,
                              MN_SERIAL_BATCHES, card), flush=True)
    ms = {"fed": [], "held": []}
    clocks = {k: {} for k in ms}
    for k in ("fed", "held", "held", "fed"):
        run.clock = clocks[k]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.steps(MN_TIMED_STEPS, held=k == "held")
        torch.cuda.synchronize()
        ms[k].append((time.perf_counter() - t0) / MN_TIMED_STEPS * 1e3)
    out = {}
    for k in ms:
        step = out[k] = float(np.mean(ms[k]))
        busy, top = device_time(lambda: run.steps(MN_PROFILE_STEPS,
                                                  held=k == "held"),
                                1, per=MN_PROFILE_STEPS)
        out[k + " busy"] = busy
        print("example/gluon/mnist.py MLP step %s: %.3f ms (%s), %.1f "
              "images/s; host ms a step by phase: %s; %s; per step: %s | %s"
              % (k, step, ", ".join("%.3f" % v for v in ms[k]),
                 MN_BATCH / step * 1e3, "; ".join(
                     "%s %.3f" % (p, v / (2 * MN_TIMED_STEPS) * 1e3)
                     for p, v in clocks[k].items()), busy_of(busy, step),
                 top, card), flush=True)
    pace = pace_line("example/gluon/mnist.py fed by vision.MNIST",
                     out["fed"], out["held"], alone, MN_BATCH,
                     out["fed busy"], card)
    return {"fed": out["fed"], "held": out["held"]}, pace


def cifar_files(mt, root, card):
    """vision.CIFAR10(train=False) over the 10,000 pickled test images,
    RandomFlipLeftRight, ToTensor and Normalize, through a DataLoader
    alone onto gpu(0): images/s. Returns the rate."""
    transforms = mt.gluon.data.vision.transforms
    test = mt.gluon.data.vision.CIFAR10(root, train=False)
    if len(test) != CIFAR_TEST or test[0][0].shape != (32, 32, 3):
        fail("vision.CIFAR10: %d samples of %s" % (len(test),
                                                   test[0][0].shape))
    loader = mt.gluon.data.DataLoader(test.transform_first(
        transforms.Compose([transforms.RandomFlipLeftRight(),
                            transforms.ToTensor(),
                            transforms.Normalize((0.49, 0.48, 0.45),
                                                 (0.25, 0.24, 0.26))])),
        batch_size=CIFAR_BATCH, num_workers=MN_WORKERS)
    rate = loader_rate(mt.gpu(0), loader)
    print("vision.CIFAR10 (%d test images, pickles) with RandomFlipLeftRight,"
          " ToTensor and Normalize through a DataLoader (%d threads, batch "
          "%d) alone onto gpu(0): %.1f images/s | %s"
          % (CIFAR_TEST, MN_WORKERS, CIFAR_BATCH, rate, card), flush=True)
    return rate


def text_files(mt, paths, root, card):
    """The first FILE_ROWS MNIST test images as a CSV pair (pixels, labels)
    and as a LibSVM file (the non-zero pixels), one epoch of CSVIter and
    of LibSVMIter (batch 64, the last batch padded), each batch staged on
    gpu(0) and equal there to the batches of the same iterator on the
    CPU."""
    import torch
    images = mt.io.read_idx(paths["test"][0], 2051)[:FILE_ROWS]
    labels = mt.io.read_idx(paths["test"][1], 2049)[:FILE_ROWS]
    rows = images.reshape(FILE_ROWS, -1)
    csv, csv_label = (os.path.join(root, n) for n in ("d.csv", "l.csv"))
    np.savetxt(csv, rows, fmt="%d", delimiter=",")
    np.savetxt(csv_label, labels, fmt="%d", delimiter=",")
    svm = os.path.join(root, "d.libsvm")
    with open(svm, "w") as f:
        for y, r in zip(labels, rows):
            nz = np.nonzero(r)[0]
            f.write("%d %s\n" % (y, " ".join("%d:%d" % (i, r[i])
                                              for i in nz)))
    for name, make in (
            ("CSVIter", lambda: mt.io.CSVIter(
                data_csv=csv, data_shape=(1, 28, 28), label_csv=csv_label,
                batch_size=MN_BATCH)),
            ("LibSVMIter", lambda: mt.io.LibSVMIter(
                data_libsvm=svm, data_shape=(784,), batch_size=MN_BATCH))):
        t0 = time.perf_counter()
        it = make()
        parse = time.perf_counter() - t0
        want = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                for b in make()]
        got = []
        t0 = time.perf_counter()
        for b in it:
            mt.io.stage_batch(b, mt.gpu(0))
            got.append((b.data[0], b.label[0], b.pad))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if len(got) != len(want) or not all(
                d.context == mt.gpu(0) and np.array_equal(d.asnumpy(), wd)
                and np.array_equal(lab.asnumpy(), wl) and p == wp
                for (d, lab, p), (wd, wl, wp) in zip(got, want)):
            fail("%s's batches staged on gpu(0) differ from its batches on "
                 "the CPU" % name)
        print("%s over %d rows (MNIST test images): parsed in %.2f s; one "
              "epoch of %d batches (last padded by %d) staged on gpu(0) in "
              "%.3f s, equal to the CPU's batches | %s"
              % (name, FILE_ROWS, parse, len(got), got[-1][2], secs, card),
              flush=True)


def data_files_phase(mt, seed, card):
    """Phase 20: MNIST's idx.gz files at their published size and
    CIFAR-10's test pickle, written from ``seed``; LeNet fed by MNISTIter,
    the Gluon MLP fed by vision.MNIST, CIFAR10 through a DataLoader, and
    CSVIter / LibSVMIter. Returns ({(path, feed): ms a step}, {model:
    pace}, the 60,000 training images as read back, for phase 35)."""
    import tempfile
    clock = [("start", time.perf_counter())]
    with tempfile.TemporaryDirectory(prefix="data_files_") as root:
        paths = mnist_files(root, seed, MN_TRAIN, MN_TEST)
        cifar_pickles(root, seed, CIFAR_TEST)
        train_images = mt.io.read_idx(paths["train"][0], 2051)
        clock.append(("files written", time.perf_counter()))
        lenet_ms, lenet_pace = lenet_files(mt, paths, card)
        clock.append(("LeNet", time.perf_counter()))
        gluon_ms, gluon_pace = gluon_files(mt, root, card)
        clock.append(("Gluon MLP", time.perf_counter()))
        cifar_files(mt, root, card)
        clock.append(("CIFAR10", time.perf_counter()))
        text_files(mt, paths, root, card)
        clock.append(("CSV and LibSVM", time.perf_counter()))
    print("data files phase: %.1f s (%s)" % (
        clock[-1][1] - clock[0][1], ", ".join(
            "%s %.1f" % (name, t - clock[i][1])
            for i, (name, t) in enumerate(clock[1:]))), flush=True)
    ms = {("LeNet", k): v for k, v in lenet_ms.items()}
    ms.update({("Gluon MLP", k): v for k, v in gluon_ms.items()})
    return ms, {"LeNet": lenet_pace, "Gluon MLP": gluon_pace}, train_images



# ---------------------------------------------------------------------------
# The op sweep on the card: every op the port registers, forward and (where
# it is differentiable) gradient on gpu(0) against the same call on cpu()
# ---------------------------------------------------------------------------

# the card's sweep against the CPU, TF32 off: outputs and gradients within
# SWEEP_TOL of each value or of the tensor's largest (cuBLAS, cuDNN and
# the reductions sum in another order than the CPU); integer outputs equal
SWEEP_TOL = dict(rtol=1e-4, atol=1e-5)


def _su(r, *shape, lo=-1.0, hi=1.0):
    return r.uniform(lo, hi, shape).astype(np.float32)


def _sa(r, *shape, lo=0.2, hi=1.0):
    """Floats bounded away from 0, either sign (kinks of abs, sign)."""
    return (r.uniform(lo, hi, shape) * r.choice([-1.0, 1.0], shape)) \
        .astype(np.float32)


def _sd(r, *shape):
    """Distinct values (no ties for max, sort, argmax)."""
    n = int(np.prod(shape))
    vals = (np.arange(n) - n / 2.0) * 0.1 + r.uniform(-0.01, 0.01, n)
    return r.permutation(vals).reshape(shape).astype(np.float32)


def _si(r, *shape, high):
    return r.randint(0, high, shape).astype(np.int32)


def _sb(r, *shape):
    return r.randint(0, 2, shape).astype(np.float32)


def _sweep_anchors(n=16):
    """n boxes of a 4x4 grid on the unit square (corner form)."""
    g = (np.arange(4) + 0.5) / 4
    cx, cy = np.meshgrid(g, g)
    half = 0.15
    return np.stack([cx - half, cy - half, cx + half, cy + half],
                    -1).reshape(1, n, 4).astype(np.float32)


def _sweep_rnn(r):
    from mxtpu_torch.ops.rnn import rnn_param_size
    T, N, I, H = 4, 2, 3, 5
    return [_su(r, T, N, I), _su(r, rnn_param_size("lstm", I, H, 1, False),
                                  lo=-0.3, hi=0.3),
            _su(r, 1, N, H), _su(r, 1, N, H)]


_SWEEP_POS = {"log": 0.3, "log10": 0.3, "log2": 0.3, "sqrt": 0.3,
              "rsqrt": 0.3, "cbrt": 0.3, "rcbrt": 0.3, "gamma": 0.5,
              "gammaln": 0.5}
_SWEEP_RANGE = {"arcsin": (-0.8, 0.8), "arccos": (-0.8, 0.8),
                "arctanh": (-0.8, 0.8), "arccosh": (1.5, 3.0),
                "log1p": (-0.5, 2.0), "ceil": (-3, 3), "floor": (-3, 3),
                "trunc": (-3, 3), "fix": (-3, 3), "rint": (-3, 3),
                "round": (-3, 3), "radians": (-180, 180)}

# {op: (inputs from a RandomState, params)}: one row for every op the port
# registers (a CPU test holds the table to the registry); no mxtpu import
CARD_SWEEP = {}
for _n in ("abs", "sign", "relu", "reciprocal", "softsign"):
    CARD_SWEEP[_n] = (lambda r: [_sa(r, 3, 4)], {})
for _n in ("negative", "exp", "expm1", "square", "sigmoid", "tanh", "sin",
           "cos", "tan", "sinh", "cosh", "arcsinh", "arctan", "degrees",
           "erf", "softrelu", "identity", "BlockGrad", "zeros_like",
           "ones_like", "L2Normalization", "log_softmax", "softmax",
           "SoftmaxActivation", "flatten"):
    CARD_SWEEP[_n] = (lambda r: [_su(r, 3, 4)], {})
for _n, _lo in _SWEEP_POS.items():
    CARD_SWEEP[_n] = ((lambda lo: lambda r: [_su(r, 3, 4, lo=lo, hi=3.0)])(
        _lo), {})
for _n, (_lo, _hi) in _SWEEP_RANGE.items():
    CARD_SWEEP[_n] = ((lambda lo, hi: lambda r: [_su(r, 3, 4, lo=lo,
                                                      hi=hi)])(_lo, _hi), {})
CARD_SWEEP["logical_not"] = (
    lambda r: [r.choice([0.0, 1.0, 2.0], (3, 4)).astype("f")], {})
for _n in ("plus", "minus", "rminus", "mul", "div", "maximum", "minimum",
           "hypot"):
    CARD_SWEEP["_%s_scalar" % _n] = (lambda r: [_sa(r, 3, 4)],
                                     {"scalar": 0.7})
CARD_SWEEP["_rdiv_scalar"] = (lambda r: [_sa(r, 3, 4, lo=0.5)],
                              {"scalar": 2.0})
CARD_SWEEP["_mod_scalar"] = (lambda r: [_su(r, 3, 4, lo=2.1, hi=2.9)],
                             {"scalar": 0.8})
CARD_SWEEP["_rmod_scalar"] = (lambda r: [_su(r, 3, 4, lo=0.7, hi=0.95)],
                              {"scalar": 2.5})
CARD_SWEEP["_power_scalar"] = (lambda r: [_su(r, 3, 4, lo=0.3, hi=2.0)],
                               {"scalar": 2.5})
CARD_SWEEP["_rpower_scalar"] = (lambda r: [_su(r, 3, 4, lo=-2, hi=2)],
                                {"scalar": 2.0})
for _n in ("equal", "not_equal", "greater", "greater_equal", "lesser",
           "lesser_equal", "logical_and", "logical_or", "logical_xor"):
    CARD_SWEEP["_%s_scalar" % _n] = (
        lambda r: [r.choice([0.0, 0.5, 1.0], (3, 4)).astype("f")],
        {"scalar": 0.5})
    CARD_SWEEP["broadcast_" + _n] = (lambda r: [_sb(r, 3, 4), _sb(r, 1, 4)],
                                     {})
for _n in ("add", "sub", "mul", "maximum", "minimum", "hypot"):
    CARD_SWEEP["broadcast_" + _n] = (lambda r: [_sd(r, 3, 4), _sa(r, 1, 4)],
                                     {})
CARD_SWEEP["broadcast_div"] = (
    lambda r: [_su(r, 3, 4), _su(r, 1, 4, lo=0.3, hi=2.0)], {})
CARD_SWEEP["broadcast_mod"] = (
    lambda r: [_su(r, 3, 4, lo=2.1, hi=2.9), _su(r, 1, 4, lo=0.7, hi=0.95)],
    {})
CARD_SWEEP["broadcast_power"] = (
    lambda r: [_su(r, 3, 4, lo=0.3, hi=2.0), _su(r, 1, 4, lo=-2, hi=2)], {})
CARD_SWEEP["arctan2"] = (lambda r: [_sa(r, 3, 4), _sa(r, 3, 4)], {})
CARD_SWEEP["add_n"] = (lambda r: [_su(r, 3, 4) for _ in range(3)], {})
CARD_SWEEP["where"] = (lambda r: [_sb(r, 3, 4), _su(r, 3, 4), _su(r, 3, 4)],
                       {})
CARD_SWEEP["clip"] = (lambda r: [_sd(r, 3, 4)], {"a_min": -0.45,
                                                 "a_max": 0.45})
CARD_SWEEP["smooth_l1"] = (lambda r: [_su(r, 3, 4, lo=-2, hi=2)],
                           {"scalar": 1.0})
for _n, _p in (("sum", {"axis": 1}), ("mean", {"axis": 0, "keepdims": True}),
               ("max", {"axis": 1}), ("min", {"axis": (0, 2)}),
               ("nansum", {"axis": 1}), ("norm", {"axis": 1}),
               ("argmax", {"axis": 1}), ("argmin", {"axis": 0}),
               ("argmax_channel", {}), ("sort", {"is_ascend": False}),
               ("argsort", {}), ("topk", {"k": 2, "ret_typ": "both"})):
    CARD_SWEEP[_n] = (lambda r: [_sd(r, 3, 4, 2)], _p)
for _n in ("prod", "nanprod"):
    CARD_SWEEP[_n] = (lambda r: [_su(r, 3, 4, lo=0.5, hi=1.5)], {"axis": 1})
CARD_SWEEP.update({
    "cast": (lambda r: [_su(r, 3, 4)], {"dtype": "float16"}),
    "concat": (lambda r: [_su(r, 2, 3), _su(r, 2, 4)], {"dim": 1}),
    "stack": (lambda r: [_su(r, 3, 4), _su(r, 3, 4)], {"axis": 1}),
    "split": (lambda r: [_su(r, 2, 6)], {"num_outputs": 3, "axis": 1}),
    "reshape": (lambda r: [_su(r, 2, 6)], {"shape": (3, -1)}),
    "expand_dims": (lambda r: [_su(r, 3, 4)], {"axis": 1}),
    "squeeze": (lambda r: [_su(r, 3, 1, 4)], {"axis": 1}),
    "transpose": (lambda r: [_su(r, 2, 3, 4)], {"axes": (2, 0, 1)}),
    "swapaxes": (lambda r: [_su(r, 2, 3, 4)], {"dim1": 0, "dim2": 2}),
    "tile": (lambda r: [_su(r, 2, 3)], {"reps": (2, 2)}),
    "repeat": (lambda r: [_su(r, 2, 3)], {"repeats": 2, "axis": 1}),
    "reverse": (lambda r: [_su(r, 3, 4)], {"axis": 1}),
    "slice": (lambda r: [_su(r, 4, 5)], {"begin": (None, 4),
                                         "end": (None, 0),
                                         "step": (2, -1)}),
    "slice_axis": (lambda r: [_su(r, 4, 5)], {"axis": 1, "begin": 1,
                                              "end": 4}),
    "slice_like": (lambda r: [_su(r, 4, 5), _su(r, 2, 3)], {}),
    "take": (lambda r: [_su(r, 4, 3), _si(r, 5, high=6)], {"mode": "wrap"}),
    "batch_take": (lambda r: [_su(r, 3, 4), _si(r, 3, high=4)], {}),
    "pick": (lambda r: [_su(r, 3, 4), _si(r, 3, high=4).astype("f")],
             {"axis": 1}),
    "gather_nd": (lambda r: [_su(r, 4, 5), _si(r, 2, 3, high=4)], {}),
    "scatter_nd": (lambda r: [_su(r, 4),
                              np.array([[0, 2, 0, 3]], np.int32)],
                   {"shape": (5,)}),
    "one_hot": (lambda r: [_si(r, 5, high=4)], {"depth": 4}),
    "depth_to_space": (lambda r: [_su(r, 1, 8, 2, 2)], {"block_size": 2}),
    "space_to_depth": (lambda r: [_su(r, 1, 2, 4, 4)], {"block_size": 2}),
    "diag": (lambda r: [_su(r, 4, 4)], {"k": 1}),
    "broadcast_axis": (lambda r: [_su(r, 3, 1)], {"axis": 1, "size": 4}),
    "broadcast_like": (lambda r: [_su(r, 3, 1), _su(r, 3, 4)], {}),
    "broadcast_to": (lambda r: [_su(r, 3, 1)], {"shape": (3, 4)}),
    "pad": (lambda r: [_su(r, 1, 2, 3, 4, 3)],
            {"mode": "reflect", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1, 1, 1)}),
    "_index": (lambda r: [_su(r, 4, 5)], {"key": (slice(1, 3),)}),
    "shape_array": (lambda r: [_su(r, 3, 4)], {}),
    "size_array": (lambda r: [_su(r, 3, 4)], {}),
    "_ones": (lambda r: [], {"shape": (3, 4)}),
    "_zeros": (lambda r: [], {"shape": (3, 4)}),
    "dot": (lambda r: [_su(r, 2, 3, 4), _su(r, 4, 5)], {}),
    "batch_dot": (lambda r: [_su(r, 2, 4, 3), _su(r, 2, 4, 5)],
                  {"transpose_a": True}),
    "Activation": (lambda r: [_sa(r, 3, 4)], {"act_type": "softrelu"}),
    "LeakyReLU": (lambda r: [_sa(r, 3, 4)], {"act_type": "elu",
                                             "slope": 0.3}),
    "FullyConnected": (lambda r: [_su(r, 2, 3), _su(r, 4, 3), _su(r, 4)],
                       {"num_hidden": 4}),
    "Convolution": (lambda r: [_su(r, 2, 4, 6, 6), _su(r, 6, 2, 3, 3),
                               _su(r, 6)],
                    {"kernel": (3, 3), "num_filter": 6, "pad": (1, 1),
                     "stride": (2, 2), "num_group": 2}),
    "Deconvolution": (lambda r: [_su(r, 1, 4, 4, 4), _su(r, 4, 3, 4, 4),
                                 _su(r, 6)],
                      {"kernel": (4, 4), "num_filter": 6, "stride": (2, 2),
                       "adj": (1, 1), "num_group": 2, "no_bias": False}),
    "Pooling": (lambda r: [_sd(r, 1, 2, 5, 5)],
                {"kernel": (2, 2), "pool_type": "max", "stride": (2, 2),
                 "pooling_convention": "full"}),
    "BatchNorm": (lambda r: [_su(r, 2, 3, 4), _su(r, 3, lo=0.3, hi=2.0),
                             _su(r, 3), _su(r, 3),
                             _su(r, 3, lo=0.3, hi=2.0)],
                  {"fix_gamma": False, "use_global_stats": True}),
    "LayerNorm": (lambda r: [_su(r, 3, 4), _su(r, 4), _su(r, 4)], {}),
    "InstanceNorm": (lambda r: [_su(r, 2, 3, 5), _su(r, 3), _su(r, 3)], {}),
    "LRN": (lambda r: [_su(r, 1, 4, 3, 3)], {"alpha": 1e-2, "nsize": 3}),
    "Embedding": (lambda r: [_si(r, 2, 3, high=5).astype("f"),
                             _su(r, 5, 4)],
                  {"input_dim": 5, "output_dim": 4}),
    "Dropout": (lambda r: [_su(r, 3, 4)], {"p": 0.5}),
    # a repeated symbol (no skip) and a 0-padded label, blank "first"
    "ctc_loss": (lambda r: [_su(r, 6, 2, 5),
                            np.array([[1, 2, 0], [3, 3, 1]], np.float32)],
                 {}),
    "UpSampling": (lambda r: [_su(r, 1, 2, 3, 3), _su(r, 1, 2, 3, 3)],
                   {"scale": 2, "num_args": 2, "multi_input_mode": "sum"}),
    "Crop": (lambda r: [_su(r, 1, 2, 7, 6), _su(r, 1, 1, 4, 3)],
             {"offset": (2, 1)}),
    "MakeLoss": (lambda r: [_su(r, 3)], {"grad_scale": 0.5}),
    "SoftmaxOutput": (lambda r: [_su(r, 2, 4, 3),
                                 _si(r, 2, 3, high=4).astype("f")],
                      {"multi_output": True}),
    "LinearRegressionOutput": (lambda r: [_su(r, 3, 4), _su(r, 3, 4)], {}),
    "MAERegressionOutput": (lambda r: [_su(r, 3, 4), _su(r, 3, 4)], {}),
    "LogisticRegressionOutput": (lambda r: [_su(r, 3, 4), _su(r, 3, 4)], {}),
    "SVMOutput": (lambda r: [_su(r, 3, 4), _si(r, 3, high=4).astype("f")],
                  {"margin": 0.5}),
    "RNN": (_sweep_rnn, {"state_size": 5, "num_layers": 1, "mode": "lstm",
                         "state_outputs": True}),
    "Custom": (lambda r: [_su(r, 3, 4)], {"op_type": "sweep_square"}),
    "_contrib_flash_attention": (
        lambda r: [_su(r, 1, 2, 32, 16), _su(r, 1, 2, 32, 16),
                   _su(r, 1, 2, 32, 16)], {"causal": True}),
    "BilinearSampler": (lambda r: [_su(r, 1, 2, 5, 5),
                                   _su(r, 1, 2, 4, 4, lo=-0.7, hi=0.7)], {}),
    "GridGenerator": (lambda r: [np.array([[1.1, 0.1, 0.05, -0.1, 0.9,
                                            -0.05]], np.float32)],
                      {"transform_type": "affine", "target_shape": (4, 4)}),
    "SpatialTransformer": (lambda r: [_su(r, 1, 2, 5, 5),
                                      np.array([[1.0, 0.1, 0.05, -0.1, 0.9,
                                                 -0.05]], np.float32)],
                           {"target_shape": (4, 4)}),
    "ROIPooling": (lambda r: [_sd(r, 1, 2, 6, 6),
                              np.array([[0, 0, 0, 3, 3], [0, 1, 1, 5, 5]],
                                       np.float32)],
                   {"pooled_size": (2, 2), "spatial_scale": 1.0}),
    "_contrib_PSROIPooling": (
        lambda r: [_su(r, 1, 8, 6, 6), np.array([[0, 0, 0, 4, 4]],
                                                np.float32)],
        {"output_dim": 2, "pooled_size": 2, "spatial_scale": 1.0}),
    "Correlation": (lambda r: [_su(r, 1, 2, 5, 5), _su(r, 1, 2, 5, 5)],
                    {"kernel_size": 1, "max_displacement": 1}),
    "SequenceLast": (lambda r: [_su(r, 4, 3, 2),
                                np.array([2, 4, 3], np.float32)],
                     {"use_sequence_length": True}),
    "SequenceMask": (lambda r: [_su(r, 4, 3, 2),
                                np.array([2, 4, 3], np.float32)],
                     {"use_sequence_length": True, "value": -1.0}),
    "SequenceReverse": (lambda r: [_su(r, 4, 3, 2),
                                   np.array([2, 4, 3], np.float32)],
                        {"use_sequence_length": True}),
    # the write at pos 4 clamps to row S - T = 3, as dynamic_update_slice
    "cached_attention": (
        lambda r: [_su(r, 2, 3, 8), _su(r, 2, 3, 8), _su(r, 2, 3, 8),
                   _su(r, 2, 6, 8), _su(r, 2, 6, 8),
                   np.array([1, 4], np.float32)],
        {"num_heads": 2, "alibi": True}),
    # top-2 at capacity factor 1: some tokens find their experts full
    "moe_ffn": (lambda r: [_su(r, 2, 8, 8), _su(r, 8, 4), _su(r, 4, 8, 6),
                           _su(r, 4, 6), _su(r, 4, 6, 8), _su(r, 4, 8)],
                {"capacity_factor": 1.0, "num_selected": 2}),
    "_contrib_MultiBoxPrior": (lambda r: [_su(r, 1, 3, 4, 4)],
                               {"sizes": (0.5, 0.3), "ratios": (1.0, 2.0)}),
    "_contrib_MultiBoxTarget": (
        lambda r: [_sweep_anchors(),
                   np.array([[[0, 0.1, 0.1, 0.6, 0.6],
                              [1, 0.5, 0.4, 0.9, 0.95]]], np.float32),
                   _su(r, 1, 3, 16)], {}),
    "_contrib_MultiBoxDetection": (
        lambda r: [np.exp(_su(r, 1, 3, 16)) / np.exp(_su(r, 1, 3, 16)).sum(
            1, keepdims=True), _su(r, 1, 64, lo=-0.1, hi=0.1),
                   _sweep_anchors()], {"nms_threshold": 0.3}),
    "_contrib_Proposal": (
        lambda r: [_su(r, 1, 24, 4, 4, lo=0.0, hi=1.0),
                   _su(r, 1, 48, 4, 4, lo=-0.1, hi=0.1),
                   np.array([[64, 64, 1]], np.float32)],
        {"rpn_pre_nms_top_n": 12, "rpn_post_nms_top_n": 4,
         "rpn_min_size": 1}),
    "_contrib_MultiProposal": (
        lambda r: [_su(r, 2, 24, 4, 4, lo=0.0, hi=1.0),
                   _su(r, 2, 48, 4, 4, lo=-0.1, hi=0.1),
                   np.array([[64, 64, 1], [64, 64, 1]], np.float32)],
        {"rpn_pre_nms_top_n": 12, "rpn_post_nms_top_n": 4,
         "rpn_min_size": 1}),
})


def _spd(r, n):
    """A symmetric positive-definite n x n matrix."""
    b = r.uniform(-1, 1, (n, n))
    return (b @ b.T + n * np.eye(n)).astype(np.float32)


def _lower(r, n):
    return (np.tril(r.uniform(0.5, 1.5, (n, n))) + np.eye(n)) \
        .astype(np.float32)


def _box_rows(r, n=12):
    """n box_nms rows (id, score, x1, y1, x2, y2): three ids, boxes of a
    few clusters so that some overlap."""
    ctr = r.uniform(0.2, 0.8, (3, 2))[r.randint(0, 3, n)] \
        + r.uniform(-0.05, 0.05, (n, 2))
    half = r.uniform(0.08, 0.15, (n, 2))
    return np.concatenate([r.randint(0, 3, (n, 1)), r.uniform(0, 1, (n, 1)),
                           ctr - half, ctr + half], 1)[None].astype("f")


_SHAPE = {"shape": (3, 4)}
for _n, _p in (("random_uniform", {"low": -1.0, "high": 3.0}),
               ("random_normal", {"loc": 2.0, "scale": 3.0}),
               ("random_gamma", {"alpha": 3.0, "beta": 2.0}),
               ("random_exponential", {"lam": 2.0}),
               ("random_poisson", {"lam": 4.0}),
               ("random_negative_binomial", {"k": 3, "p": 0.5}),
               ("random_generalized_negative_binomial", {"mu": 2.0,
                                                         "alpha": 0.5}),
               ("random_randint", {"low": 2, "high": 8})):
    CARD_SWEEP[_n] = (lambda r: [], dict(_p, **_SHAPE))
for _n in ("sample_uniform", "sample_normal", "sample_gamma",
           "sample_negative_binomial", "sample_generalized_negative_binomial"):
    CARD_SWEEP[_n] = (lambda r: [_su(r, 2, lo=0.5, hi=2.0),
                                 _su(r, 2, lo=0.3, hi=0.7)], {"shape": (5,)})
for _n in ("sample_exponential", "sample_poisson"):
    CARD_SWEEP[_n] = (lambda r: [_su(r, 2, lo=0.5, hi=4.0)], {"shape": (5,)})
_W = (lambda r: _su(r, 3, 4))
CARD_SWEEP.update({
    "sample_multinomial": (
        lambda r: [np.array([[0.7, 0.2, 0.1], [0.05, 0.05, 0.9]], "f")],
        {"shape": (5,), "get_prob": True}),
    "shuffle": (lambda r: [_su(r, 6, 3)], {}),
    "khatri_rao": (lambda r: [_su(r, 2, 4), _su(r, 3, 4)], {}),
    "linalg_gemm": (lambda r: [_su(r, 2, 3, 4), _su(r, 2, 4, 5),
                               _su(r, 2, 3, 5)],
                    {"alpha": 2.0, "beta": 0.5}),
    "linalg_gemm2": (lambda r: [_su(r, 3, 4), _su(r, 5, 4)],
                     {"alpha": 1.5, "transpose_b": True}),
    "linalg_syrk": (lambda r: [_su(r, 3, 4)], {"alpha": 0.5}),
    "linalg_trmm": (lambda r: [_lower(r, 3), _su(r, 3, 4)], {}),
    "linalg_trsm": (lambda r: [_lower(r, 3), _su(r, 4, 3)],
                    {"rightside": True}),
    "linalg_sumlogdiag": (lambda r: [_spd(r, 3)], {}),
    "linalg_potrf": (lambda r: [_spd(r, 3)], {}),
    "linalg_potri": (lambda r: [np.linalg.cholesky(_spd(r, 3))
                                .astype(np.float32)], {}),
    "linalg_gelqf": (lambda r: [_su(r, 3, 5)], {}),
    "linalg_syevd": (lambda r: [_spd(r, 3)], {}),
    "sgd_update": (lambda r: [_W(r), _W(r)], {"lr": 0.1, "wd": 0.01}),
    "sgd_mom_update": (lambda r: [_W(r), _W(r), _W(r)],
                       {"lr": 0.1, "momentum": 0.9, "wd": 0.01}),
    "mp_sgd_update": (lambda r: [_W(r).astype(np.float16),
                                 _W(r).astype(np.float16), _W(r)],
                      {"lr": 0.1, "wd": 0.01}),
    "mp_sgd_mom_update": (lambda r: [_W(r).astype(np.float16),
                                     _W(r).astype(np.float16), _W(r),
                                     _W(r)], {"lr": 0.1, "momentum": 0.9}),
    "adam_update": (lambda r: [_W(r), _W(r), _W(r),
                               _su(r, 3, 4, lo=0.3, hi=2.0)],
                    {"lr": 0.01, "wd": 0.01}),
    "rmsprop_update": (lambda r: [_W(r), _W(r), _su(r, 3, 4, lo=0.3,
                                                    hi=2.0)], {"lr": 0.01}),
    "rmspropalex_update": (lambda r: [_W(r), _W(r),
                                      _su(r, 3, 4, lo=1.0, hi=2.0),
                                      _su(r, 3, 4, lo=-0.3, hi=0.3), _W(r)],
                           {"lr": 0.01}),
    "ftml_update": (lambda r: [_W(r), _W(r), _su(r, 3, 4, lo=0.3, hi=2.0),
                               _su(r, 3, 4, lo=0.3, hi=2.0), _W(r)],
                    {"lr": 0.01, "t": 2}),
    "signsgd_update": (lambda r: [_W(r), _sa(r, 3, 4)], {"lr": 0.1}),
    "signum_update": (lambda r: [_W(r), _sa(r, 3, 4), _W(r)],
                      {"lr": 0.1, "momentum": 0.9}),
    "ftrl_update": (lambda r: [_W(r), _W(r), _W(r),
                               _su(r, 3, 4, lo=0.3, hi=2.0)], {"lr": 0.1}),
    "adagrad_update": (lambda r: [_W(r), _W(r), _su(r, 3, 4, lo=0.3,
                                                    hi=2.0)], {"lr": 0.1}),
    "_contrib_box_iou": (lambda r: [_box_rows(r)[0, :, 2:],
                                    _box_rows(r, 5)[0, :, 2:]], {}),
    "_contrib_box_nms": (lambda r: [np.concatenate([_box_rows(r),
                                                    _box_rows(r)])],
        {"overlap_thresh": 0.3, "valid_thresh": 0.1, "topk": 10,
         "id_index": 0}),
    "_contrib_bipartite_matching": (lambda r: [_sd(r, 2, 4, 3)],
                                    {"threshold": -0.3}),
    "_contrib_DeformableConvolution": (
        lambda r: [_su(r, 2, 4, 6, 6), _su(r, 2, 36, 6, 6, lo=-1.5, hi=1.5),
                   _su(r, 4, 2, 3, 3), _su(r, 4)],
        {"kernel": (3, 3), "num_filter": 4, "pad": (2, 2),
         "dilate": (2, 2), "num_group": 2, "num_deformable_group": 2}),
    "_contrib_DeformablePSROIPooling": (
        lambda r: [_su(r, 1, 8, 6, 6),
                   np.array([[0, 0.5, 0.5, 4.5, 4.0]], np.float32),
                   _su(r, 1, 8, lo=-0.5, hi=0.5)],
        {"output_dim": 2, "pooled_size": 2, "group_size": 2, "part_size": 2,
         "trans_std": 0.1, "spatial_scale": 1.0}),
    "reshape_like": (lambda r: [_su(r, 2, 6), _su(r, 3, 4)], {}),
    "softmax_cross_entropy": (lambda r: [_su(r, 3, 4),
                                         _si(r, 3, high=4).astype("f")], {}),
    "_contrib_quadratic": (lambda r: [_su(r, 3, 4)],
                           {"a": 2.0, "b": -1.0, "c": 0.5}),
    "IdentityAttachKLSparseReg": (lambda r: [_su(r, 3, 4)],
                                  {"penalty": 0.1}),
    "_image_to_tensor": (lambda r: [r.randint(0, 256, (2, 5, 4, 3))
                                    .astype(np.uint8)], {}),
    "_image_normalize": (lambda r: [_su(r, 3, 4, 5, lo=0, hi=1)],
                         {"mean": (0.5, 0.4, 0.3), "std": (0.2, 0.25, 0.3)}),
    "_contrib_quantize": (lambda r: [_su(r, 3, 4, lo=-0.9, hi=0.9),
                                     np.array([-1.0], "f"),
                                     np.array([1.0], "f")],
                          {"out_type": "int8"}),
    "_contrib_dequantize": (lambda r: [r.randint(0, 256, (3, 4))
                                       .astype(np.uint8),
                                       np.array([-1.0], "f"),
                                       np.array([1.0], "f")], {}),
    "_contrib_fft": (lambda r: [_su(r, 2, 8)], {}),
    "_contrib_ifft": (lambda r: [_su(r, 2, 16)], {}),
    "_contrib_count_sketch": (
        lambda r: [_su(r, 2, 5), np.array([0, 2, 1, 0, 3], "f"),
                   np.array([1, -1, 1, -1, 1], "f")], {"out_dim": 4}),
})


def sweep_register(mt):
    """The custom op the sweep's ``Custom`` row calls: x^2 with its
    gradient, written in the NDArray API (so it runs on either device)."""
    from mxtpu_torch import operator

    class Square(operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * in_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], 2 * in_data[0] * out_grad[0])

    @operator.register("sweep_square")
    class SquareProp(operator.CustomOpProp):
        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Square()


def sweep_row(mt, name, ctx, seed=0):
    """Op ``name``'s row of CARD_SWEEP through ``mt.nd`` on ``ctx``:
    (its outputs as numpy, and where the op is differentiable the
    gradients of sum(cotangent * output) with respect to its float
    inputs, else []). The generator is reseeded first, so a stochastic
    op draws the same on either device."""
    from mxtpu_torch.ops.registry import get_op
    make, params = CARD_SWEEP[name]
    r = np.random.RandomState(seed)
    args = make(r)
    op = get_op(name)
    fidx = [i for i, a in enumerate(args)
            if isinstance(a, np.ndarray) and a.dtype.kind == "f"] \
        if op.differentiable else []
    fn = getattr(mt.nd, name)
    with ctx:
        mt.random.seed(seed)
        nds = [mt.nd.array(a, ctx=ctx) if isinstance(a, np.ndarray) else a
               for a in args]
        out = fn(*nds, **params)
        outs = [o.asnumpy() for o in (out if isinstance(out, list)
                                      else [out])]
        if not fidx:
            return outs, []
        mt.random.seed(seed)
        for i in fidx:
            nds[i].attach_grad()
        with mt.autograd.record():
            out = fn(*nds, **params)
        out = out if isinstance(out, list) else [out]
        heads = [(o, mt.nd.array(r.normal(0, 1, o.shape).astype("f"),
                                 ctx=ctx, dtype=o.dtype))
                 for o in out if o.data.requires_grad]
        if heads:
            mt.autograd.backward([h[0] for h in heads],
                                 head_grads=[h[1] for h in heads])
        grads = [nds[i].grad.asnumpy() if heads and nds[i].grad is not None
                 else np.zeros(args[i].shape, np.float32) for i in fidx]
    return outs, grads


def sweep_close(got, want):
    """None if ``got`` matches ``want`` (SWEEP_TOL, of each value or of
    the largest; integers and bools exactly), else what differs."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return "%s %s against %s %s" % (got.shape, got.dtype, want.shape,
                                        want.dtype)
    if got.dtype.kind not in "fc":
        return None if np.array_equal(got, want) else "integers differ"
    g, w = got.astype(np.float64), want.astype(np.float64)
    if not np.array_equal(np.isnan(g), np.isnan(w)):
        return "NaNs differ"
    ok = ~np.isnan(w)
    scale = max(1.0, float(np.abs(w[ok]).max())) if ok.any() else 1.0
    err = np.abs(g[ok] - w[ok])
    if (err > SWEEP_TOL["atol"] * scale + SWEEP_TOL["rtol"] * np.abs(
            w[ok])).any():
        return "max |diff| %.3g" % float(err.max())
    return None


def op_sweep_phase(mt, card):
    """Every registered op's CARD_SWEEP row on gpu(0) against cpu(): the
    outputs and, where differentiable, the gradients. Prints the count
    that passed and the names that failed; any failure fails the run."""
    from mxtpu_torch.ops.registry import _REGISTRY
    t0 = time.time()
    sweep_register(mt)
    names = sorted({op.name for op in _REGISTRY.values()})
    if set(names) != set(CARD_SWEEP):
        fail("the op sweep's table and the registry differ: %s"
             % sorted(set(names) ^ set(CARD_SWEEP)))
    failed, grads = {}, 0
    for name in names:
        try:
            got_o, got_g = sweep_row(mt, name, mt.gpu(0))
            want_o, want_g = sweep_row(mt, name, mt.cpu())
        except Exception as e:      # noqa: BLE001 - reported, then fatal
            failed[name] = "raised %s: %s" % (type(e).__name__, e)
            continue
        grads += bool(want_g)
        diffs = [sweep_close(g, w) for g, w in zip(got_o + got_g,
                                                    want_o + want_g)]
        if len(got_o) != len(want_o) or any(diffs):
            failed[name] = "; ".join(d for d in diffs if d) or "arity"
    print("op sweep on gpu(0) against cpu() (TF32 off, tolerance %s): %d of "
          "%d ops passed (%d with gradients) in %.1f s; failed: %s | %s"
          % (SWEEP_TOL, len(names) - len(failed), len(names), grads,
             time.time() - t0, ", ".join("%s (%s)" % kv for kv in
                                         sorted(failed.items())) or "none",
             card), flush=True)
    if failed:
        fail("the op sweep failed on the card for %s" % sorted(failed))
    return len(names), box_nms_check(mt, card)


# box_nms held at a cut row count (the CPU's plain loop is a launch a row),
# timed at SSD-300's
BOX_NMS_ROWS, BOX_NMS_BATCH = 1024, 2
BOX_NMS = dict(overlap_thresh=SSD_NMS_THRESHOLD, valid_thresh=0.01,
               coord_start=2, score_index=1, id_index=0)


def box_nms_rows(mt, rng, batch, rows):
    """box_nms's rows (id, score, x1, y1, x2, y2) on gpu(0): SSD-300's
    decoded detections before their NMS (nms_inputs) over its first
    ``rows`` anchors, the class id -1 where no class passes."""
    import torch
    from mxtpu_torch.ops import vision
    anchors = ssd300_anchors(mt, mt.gpu(0)).data[:, :rows]
    cls_id, score, boxes = nms_inputs(vision, anchors, rng, batch)
    return torch.cat([cls_id[..., None], score[..., None], boxes], -1)


def box_nms_check(mt, card):
    """nd.contrib.box_nms on gpu(0), whose NMS is the multibox_nms kernel,
    against the CPU's box_nms (its NMS the kernel's plain loop,
    multibox_nms_plain) at BOX_NMS_ROWS rows, plain and with topk 100 and
    force_suppress: equal, and bitwise repeatable; the kernel's launches
    counted from 0 over those calls. Then box_nms and the kernel alone
    timed at SSD-300's 8,732 rows. Returns (launches, box_nms ms, the
    kernel's ms)."""
    import torch
    from mxtpu_torch.ops import vision
    rng = np.random.RandomState(11)
    data = mt.nd.NDArray(box_nms_rows(mt, rng, BOX_NMS_BATCH, BOX_NMS_ROWS))
    host = data.as_in_context(mt.cpu())
    vision.LAUNCHES["multibox_nms"] = 0
    kept = []
    for extra in ({}, {"topk": 100}, {"force_suppress": True}):
        params = dict(BOX_NMS, **extra)
        got = mt.nd.contrib.box_nms(data, **params)
        again = mt.nd.contrib.box_nms(data, **params)
        want = mt.nd.contrib.box_nms(host, **params)
        if not torch.equal(got.data, again.data):
            fail("box_nms %s on gpu(0): two calls differ" % extra)
        if not np.array_equal(got.asnumpy(), want.asnumpy()):
            fail("box_nms %s on gpu(0) differs from the CPU's plain loop"
                 % extra)
        kept.append(int((got.asnumpy()[..., 1] >= 0).sum()))
    launches = vision.LAUNCHES["multibox_nms"]
    if launches != 6:
        fail("box_nms launched multibox_nms %d times for 6 calls"
             % launches)
    big = mt.nd.NDArray(box_nms_rows(mt, rng, 1, SSD_ANCHORS))
    ms = cuda_ms(lambda: mt.nd.contrib.box_nms(big, **BOX_NMS), iters=20)
    out = mt.nd.contrib.box_nms(big, **BOX_NMS).data
    boxes = out[..., 2:6].contiguous()
    cls = torch.where(out[..., 1] > BOX_NMS["valid_thresh"], out[..., 0],
                      -1.0).contiguous()
    kernel_ms = cuda_ms(lambda: vision.multibox_nms(
        boxes, cls, SSD_NMS_THRESHOLD, False, SSD_ANCHORS), iters=20)
    print("box_nms on gpu(0) (multibox_nms after a sort by valid score, ids "
          "as class indices) at %d x %d rows: equal to the CPU's plain loop "
          "and bitwise repeatable, plain / topk 100 / force_suppress keep "
          "%s; %d launches in 6 calls; at SSD-300's %d rows %.3f ms a call, "
          "the kernel alone %.3f ms (CUDA events, 20 calls) | %s"
          % (BOX_NMS_BATCH, BOX_NMS_ROWS, kept, launches, SSD_ANCHORS, ms,
             kernel_ms, card), flush=True)
    return launches, ms, kernel_ms



# ---------------------------------------------------------------------------
# The examples the op sweep's ops open, each a mirror of the example's main
# (the examples import mxtpu) with ``pkg`` for mxtpu and the context a
# parameter where the example hard-codes cpu()
# ---------------------------------------------------------------------------

# first steps, card against the CPU: each array (a Module example's
# weight steps, a Gluon loop's losses, weights or image) within EX_SHARE of
# its largest value, or of EX_FLOOR times the example's largest where that
# is more: a bias before a BatchNorm has no gradient, so its step is
# rounding alone
EX_SHARE, EX_FLOOR = 1e-3, 1e-2
FCN_TOY_HW, FCN_TOY_CLASSES = 32, 2
NDSB_FRAMES, NDSB_IMG, NDSB_BINS = 30, 32, 600
NCE_VOCAB, NCE_EMBED, NCE_K = 200, 32, 8
STYLE_HW = 24


def fcn_toy_data(n, seed=0):
    """example/fcn-xs/fcn_toy.py's make_data: a bright square on noise."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 0.3, (n, 1, FCN_TOY_HW, FCN_TOY_HW)).astype("f")
    y = np.zeros((n, FCN_TOY_HW, FCN_TOY_HW), "f")
    for i in range(n):
        size = rng.randint(8, 18)
        r0 = rng.randint(0, FCN_TOY_HW - size)
        c0 = rng.randint(0, FCN_TOY_HW - size)
        x[i, 0, r0:r0 + size, c0:c0 + size] += 0.7
        y[i, r0:r0 + size, c0:c0 + size] = 1.0
    return x, y


def fcn_toy_symbol(pkg):
    """fcn_toy.py's get_fcn_symbol: two conv/pool stages to stride 4, a
    1x1 score, an 8x8 stride-4 Deconvolution, Crop to the data, a
    per-pixel SoftmaxOutput."""
    data = pkg.sym.var("data")
    body = data
    for i, ch in enumerate((16, 32)):
        body = pkg.sym.Convolution(body, num_filter=ch, kernel=(3, 3),
                                   pad=(1, 1), name="conv%d" % i)
        body = pkg.sym.Activation(body, act_type="relu")
        body = pkg.sym.Pooling(body, kernel=(2, 2), stride=(2, 2),
                               pool_type="max", name="pool%d" % i)
    score = pkg.sym.Convolution(body, num_filter=FCN_TOY_CLASSES,
                                kernel=(1, 1), name="score")
    up = pkg.sym.Deconvolution(score, num_filter=FCN_TOY_CLASSES,
                               kernel=(8, 8), stride=(4, 4), pad=(2, 2),
                               num_group=1, name="bigscore")
    up = pkg.sym.Crop(up, data, name="crop")
    return pkg.sym.SoftmaxOutput(up, multi_output=True, use_ignore=True,
                                 ignore_label=-1, name="softmax")


def fcn_toy_main(pkg, ctx):
    """fcn_toy.py's main on ``ctx``: Module.fit (Adam 0.01, Xavier, 6
    epochs of 12 batches), then the pixel accuracy on the training images
    (the example asserts > 0.93). Returns the accuracy."""
    np.random.seed(0)
    pkg.random.seed(0)
    x, y = fcn_toy_data(96)
    sym = fcn_toy_symbol(pkg)
    train = pkg.io.NDArrayIter(x, y, batch_size=8, shuffle=True,
                               label_name="softmax_label")
    mod = pkg.mod.Module(sym, context=ctx)
    mod.fit(train, optimizer="adam", optimizer_params={"learning_rate": 0.01},
            initializer=pkg.init.Xavier(), num_epoch=6)
    val = pkg.io.NDArrayIter(x, y, batch_size=8, label_name="softmax_label")
    correct = total = 0
    for batch in val:
        mod.forward(batch, is_train=False)
        pred = mod.get_outputs()[0].asnumpy().argmax(axis=1)
        lab = batch.label[0].asnumpy()
        correct += (pred == lab).sum()
        total += lab.size
    acc = correct / total
    if not acc > 0.93:
        fail("fcn_toy on %s: pixel accuracy %.3f (the example asserts > "
             "0.93)" % (ctx, acc))
    return float(acc)


def svm_digits(n, seed=0):
    """example/svm_mnist/svm_mnist.py's synthetic_digits."""
    protos = np.random.RandomState(0).uniform(0, 1, (10, 784)) \
        .astype(np.float32)
    r = np.random.RandomState(seed)
    y = r.randint(0, 10, n)
    x = protos[y] + 0.25 * r.randn(n, 784).astype(np.float32)
    return x.astype(np.float32), y.astype(np.float32)


def svm_symbol(pkg, use_linear=False):
    """svm_mnist.py's build: 784 -> 128 relu -> 10 -> SVMOutput."""
    data = pkg.sym.var("data")
    net = pkg.sym.FullyConnected(data, name="fc1", num_hidden=128)
    net = pkg.sym.Activation(net, name="relu1", act_type="relu")
    net = pkg.sym.FullyConnected(net, name="fc2", num_hidden=10)
    return pkg.sym.SVMOutput(net, name="svm", use_linear=use_linear,
                             margin=1.0, regularization_coefficient=1.0)


def svm_mnist_main(pkg, ctx):
    """svm_mnist.py's main on ``ctx``: the squared and the linear hinge,
    each Module.fit for 4 epochs of SGD (momentum 0.9, wd 1e-4), scored
    (the example asserts accuracy > 0.9). Returns {use_linear: acc}."""
    np.random.seed(0)
    pkg.random.seed(7)
    xtr, ytr = svm_digits(2048, seed=0)
    xte, yte = svm_digits(512, seed=1)
    batch = 128
    train = pkg.io.NDArrayIter(xtr, ytr, batch, shuffle=True,
                               label_name="svm_label")
    val = pkg.io.NDArrayIter(xte, yte, batch, label_name="svm_label")
    accs = {}
    for use_linear, lr in ((False, 1e-3), (True, 1e-2)):
        mod = pkg.mod.Module(svm_symbol(pkg, use_linear),
                             data_names=("data",),
                             label_names=("svm_label",), context=ctx)
        mod.fit(train, eval_data=val, optimizer="sgd",
                optimizer_params={"learning_rate": lr, "momentum": 0.9,
                                  "wd": 1e-4},
                eval_metric="acc", num_epoch=4)
        acc = dict(mod.score(val, "acc"))["accuracy"]
        if not acc > 0.9:
            fail("svm_mnist on %s, use_linear=%s: accuracy %.3f (the "
                 "example asserts > 0.9)" % (ctx, use_linear, acc))
        accs[use_linear] = float(acc)
    return accs


def nce_model(pkg):
    """example/nce-loss/nce_lm.py's NCEModel: logits <in_embed(center),
    out_embed(label)> by batch_dot."""
    gluon, nn = pkg.gluon, pkg.gluon.nn

    class NCEModel(gluon.Block):
        def __init__(self, **kw):
            super(NCEModel, self).__init__(**kw)
            with self.name_scope():
                self.in_embed = nn.Embedding(NCE_VOCAB, NCE_EMBED)
                self.out_embed = nn.Embedding(NCE_VOCAB, NCE_EMBED)

        def forward(self, center, labels):
            e_in = self.in_embed(center)
            e_out = self.out_embed(labels)
            return pkg.nd.batch_dot(
                e_out, pkg.nd.reshape(e_in, shape=(-1, NCE_EMBED, 1))) \
                .reshape((labels.shape[0], labels.shape[1]))
    return NCEModel()


def nce_lm_main(pkg, ctx, steps=400, weights=None):
    """nce_lm.py's main on ``ctx``: 400 Adam steps of NCE with 8 noise
    labels, then full-vocabulary retrieval (the example asserts > 0.9).
    ``weights`` ({name suffix: numpy}) replaces the Normal(0.1) draw;
    ``steps`` cuts the run (no retrieval check then). Returns (each step's
    mean loss, the accuracy or None, the weights at the end)."""
    pkg.random.seed(17)
    r = np.random.RandomState(0)
    mapping = r.permutation(NCE_VOCAB)
    net = nce_model(pkg)
    net.initialize(pkg.init.Normal(0.1), ctx=ctx)
    params = net.collect_params()
    if weights is not None:
        for k, p in params.items():
            p.set_data(pkg.nd.array(weights[k.split("_", 1)[1]], ctx=ctx))
    trainer = pkg.gluon.Trainer(params, "adam", {"learning_rate": 5e-3})
    loss_fn = pkg.gluon.loss.SigmoidBinaryCrossEntropyLoss(
        from_sigmoid=False)
    batch = 256
    losses = []
    for step in range(steps):
        center = r.randint(0, NCE_VOCAB, batch)
        true_ctx = mapping[center]
        noise = r.randint(0, NCE_VOCAB, (batch, NCE_K))
        labels = np.concatenate([true_ctx[:, None], noise], axis=1)
        target = np.zeros((batch, 1 + NCE_K), np.float32)
        target[:, 0] = 1.0
        c_nd = pkg.nd.array(center.astype(np.float32), ctx=ctx)
        l_nd = pkg.nd.array(labels.astype(np.float32), ctx=ctx)
        with pkg.autograd.record():
            logits = net(c_nd, l_nd)
            loss = loss_fn(logits, pkg.nd.array(target, ctx=ctx))
        loss.backward()
        trainer.step(batch)
        losses.append(float(loss.mean().asnumpy()))
    end = {k.split("_", 1)[1]: p.data().asnumpy() for k, p in params.items()}
    if steps < 400:
        return losses, None, end
    centers = pkg.nd.array(np.arange(NCE_VOCAB, dtype=np.float32), ctx=ctx)
    e_in = net.in_embed(centers).asnumpy()
    e_out = net.out_embed(centers).asnumpy()
    acc = float(((e_in @ e_out.T).argmax(axis=1) == mapping).mean())
    if not acc > 0.9:
        fail("nce_lm on %s: retrieval accuracy %.3f (the example asserts > "
             "0.9)" % (ctx, acc))
    return losses, acc, end


def style_extractor(pkg, ctx):
    """neural_style_toy.py's make_extractor: two fixed conv taps."""
    nn = pkg.gluon.nn
    f1 = nn.HybridSequential()
    f1.add(nn.Conv2D(8, 3, padding=1), nn.Activation("relu"))
    f2 = nn.HybridSequential()
    f2.add(nn.MaxPool2D(2), nn.Conv2D(16, 3, padding=1),
           nn.Activation("relu"))
    for f in (f1, f2):
        f.initialize(pkg.init.Xavier(rnd_type="gaussian", magnitude=2),
                     ctx=ctx)
    return f1, f2


def style_gram(pkg, feat):
    """neural_style_toy.py's gram: (c, hw) x (hw, c) by nd.dot."""
    b, c, h, w = feat.shape
    flat = pkg.nd.reshape(feat, shape=(c, h * w))
    return pkg.nd.dot(flat, flat.T) / (c * h * w)


def neural_style_main(pkg, ctx, steps=200, weights=None):
    """neural_style_toy.py's main on ``ctx``: 200 steps of gradient
    descent on the input image (content, gram-matrix style and total
    variation losses through a fixed conv extractor); the example asserts
    the loss falls below 0.4 of its start. ``weights`` (a list of numpy
    arrays in the extractor's order) replaces its Xavier draw. Returns
    (each step's loss, the image at the end)."""
    np.random.seed(0)
    pkg.random.seed(0)
    rng = np.random.RandomState(0)
    content = np.zeros((1, 3, STYLE_HW, STYLE_HW), "f")
    content[:, :, 6:18, 6:18] = 1.0
    style = np.tile((np.add.outer(np.arange(STYLE_HW), np.arange(STYLE_HW))
                     % 6 < 3).astype("f"), (1, 3, 1, 1))
    f1, f2 = style_extractor(pkg, ctx)
    c_nd = pkg.nd.array(content, ctx=ctx)
    s_nd = pkg.nd.array(style, ctx=ctx)
    if weights is not None:
        with pkg.autograd.pause():
            f2(f1(c_nd))            # the deferred shapes, then the weights
        for p, w in zip(list(f1.collect_params().values())
                        + list(f2.collect_params().values()), weights):
            p.set_data(pkg.nd.array(w, ctx=ctx))
    with pkg.autograd.pause():
        content_feat = f1(c_nd)
        s1 = f1(s_nd)
        style_grams = [style_gram(pkg, s1), style_gram(pkg, f2(s1))]
    img = pkg.nd.array(rng.uniform(0, 1, content.shape).astype("f"),
                       ctx=ctx)
    img.attach_grad()
    losses = []
    for step in range(steps):
        with pkg.autograd.record():
            feats = [f1(img)]
            feats.append(f2(feats[0]))
            closs = pkg.nd.mean(pkg.nd.square(feats[0] - content_feat))
            sloss = sum(pkg.nd.mean(pkg.nd.square(style_gram(pkg, f) - g))
                        for f, g in zip(feats, style_grams))
            tv = pkg.nd.mean(pkg.nd.square(
                img[:, :, 1:, :] - img[:, :, :-1, :])) + \
                pkg.nd.mean(pkg.nd.square(
                    img[:, :, :, 1:] - img[:, :, :, :-1]))
            loss = closs + 20.0 * sloss + 0.1 * tv
        loss.backward()
        # the example rebinds img's buffer to img - 8 grad and zeroes the
        # gradient through the private _data; here through the public API
        img[:] = img - 8.0 * img.grad
        img.grad[:] = 0
        losses.append(float(loss.asscalar()))
    if steps == 200 and not losses[-1] < losses[0] * 0.4:
        fail("neural_style_toy on %s: loss %.4f -> %.4f (the example "
             "asserts below 0.4 of the start)" % (ctx, losses[0],
                                                   losses[-1]))
    return losses, img.asnumpy()


def ndsb2_stacks(n, rng):
    """example/kaggle-ndsb2/train_ndsb2.py's synth_stacks."""
    yy, xx = np.mgrid[0:NDSB_IMG, 0:NDSB_IMG].astype(np.float32)
    data = np.empty((n, NDSB_FRAMES, NDSB_IMG, NDSB_IMG), np.float32)
    volumes = rng.uniform(30, 270, n).astype(np.float32)
    for i in range(n):
        r0 = 2.0 + volumes[i] / 40.0
        phase = rng.uniform(0, 2 * np.pi)
        for t in range(NDSB_FRAMES):
            r = r0 * (1.0 + 0.35 * np.sin(2 * np.pi * t / NDSB_FRAMES
                                          + phase))
            d2 = (xx - NDSB_IMG / 2) ** 2 + (yy - NDSB_IMG / 2) ** 2
            frame = 110.0 * (d2 < r * r) + rng.normal(0, 6,
                                                       (NDSB_IMG, NDSB_IMG))
            data[i, t] = np.clip(frame + 60.0, 0, 255)
    return data, volumes


def ndsb2_encode_label(volumes):
    return np.array([(v < np.arange(NDSB_BINS)) for v in volumes],
                    dtype=np.uint8)


def ndsb2_write_csvs(root, data, volumes):
    data_csv = os.path.join(root, "train-data.csv")
    label_csv = os.path.join(root, "train-systole.csv")
    np.savetxt(data_csv, data.reshape(len(data), -1), delimiter=",",
               fmt="%g")
    np.savetxt(label_csv, ndsb2_encode_label(volumes), delimiter=",",
               fmt="%g")
    return data_csv, label_csv


def ndsb2_lenet(pkg):
    """train_ndsb2.py's get_lenet: frame differences by SliceChannel, two
    conv/BN/relu/pool stages, dropout, 600 sigmoid outputs."""
    source = pkg.sym.Variable("data")
    source = (source - 128) * (1.0 / 128)
    frames = pkg.sym.SliceChannel(source, num_outputs=NDSB_FRAMES)
    diffs = [frames[i + 1] - frames[i] for i in range(NDSB_FRAMES - 1)]
    source = pkg.sym.Concat(*diffs)
    net = pkg.sym.Convolution(source, kernel=(5, 5), num_filter=16)
    net = pkg.sym.BatchNorm(net, fix_gamma=True)
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.Pooling(net, pool_type="max", kernel=(2, 2), stride=(2, 2))
    net = pkg.sym.Convolution(net, kernel=(3, 3), num_filter=16)
    net = pkg.sym.BatchNorm(net, fix_gamma=True)
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.Pooling(net, pool_type="max", kernel=(2, 2), stride=(2, 2))
    flatten = pkg.sym.Flatten(net)
    flatten = pkg.sym.Dropout(flatten)
    fc1 = pkg.sym.FullyConnected(data=flatten, num_hidden=NDSB_BINS)
    return pkg.sym.LogisticRegressionOutput(data=fc1, name="softmax")


def ndsb2_crps(label, pred):
    """train_ndsb2.py's CRPS metric."""
    pred = np.maximum.accumulate(pred, axis=1)
    return np.sum(np.square(label - pred)) / label.size


def ndsb2_main(pkg, ctx, root, num_cases=48, batch_size=8, num_epochs=12):
    """train_ndsb2.py's main on ``ctx`` (the example hard-codes cpu()):
    stacks through CSV files and CSVIter, FeedForward.fit (SGD 0.01,
    momentum 0.9, wd 1e-5) with the CRPS metric, then predict; the
    example asserts the CRPS below 0.6 of the all-half CDF's. Returns
    (crps, baseline)."""
    rng = np.random.RandomState(7)
    data, volumes = ndsb2_stacks(num_cases, rng)
    data_csv, label_csv = ndsb2_write_csvs(root, data, volumes)
    data_train = pkg.io.CSVIter(
        data_csv=data_csv, data_shape=(NDSB_FRAMES, NDSB_IMG, NDSB_IMG),
        label_csv=label_csv, label_shape=(NDSB_BINS,),
        batch_size=batch_size)
    model = pkg.model.FeedForward(
        ctx=ctx, symbol=ndsb2_lenet(pkg), num_epoch=num_epochs,
        learning_rate=0.01, wd=0.00001, momentum=0.9)
    model.fit(X=data_train, eval_metric=pkg.metric.np(ndsb2_crps))
    preds = model.predict(pkg.io.CSVIter(
        data_csv=data_csv, data_shape=(NDSB_FRAMES, NDSB_IMG, NDSB_IMG),
        batch_size=batch_size))
    preds = np.maximum.accumulate(np.asarray(preds), axis=1)
    truth = ndsb2_encode_label(volumes)
    crps = float(np.square(truth - preds).sum() / truth.size)
    baseline = float(np.square(truth - 0.5).sum() / truth.size)
    if not crps < 0.6 * baseline:
        fail("train_ndsb2 on %s: CRPS %.4f against the all-half %.4f (the "
             "example asserts below 0.6 of it)" % (ctx, crps, baseline))
    return crps, baseline


def module_steps(pkg, ctx, sym, data_iter, arg_params, aux_params,
                 optimizer, optimizer_params, label_names=("softmax_label",),
                 steps=FIT_STEPS, seed=0, data_names=("data",), fused=False):
    """``steps`` Module steps (forward_backward, update) of ``sym`` from
    ``arg_params`` on ``ctx`` over ``data_iter``'s first batches: {name:
    numpy} of the weights after them. Eager on either device, so a
    Dropout draws from the executor's generator, seeded alike; with
    ``fused``, the fused step (the CPU test's mxtpu side of a net without
    Dropout: one compiled program a step)."""
    want = "1" if fused else "0"
    if os.environ.get("MXTPU_MODULE_FUSED") != want:
        return with_fused(fused, module_steps, pkg, ctx, sym, data_iter,
                          arg_params, aux_params, optimizer,
                          optimizer_params, label_names, steps, seed,
                          data_names, fused)
    pkg.random.seed(seed)
    np.random.seed(seed)
    data_iter.reset()
    mod = pkg.mod.Module(sym, context=ctx, data_names=data_names,
                         label_names=label_names)
    mod.bind(data_iter.provide_data, data_iter.provide_label)
    mod.init_params(arg_params=host_params(pkg, arg_params),
                    aux_params=host_params(pkg, aux_params or {}))
    mod.init_optimizer(optimizer=optimizer,
                       optimizer_params=optimizer_params)
    for _ in range(steps):
        mod.forward_backward(data_iter.next())
        mod.update()
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def module_init(pkg, sym, data_iter, initializer, seed=0,
                label_names=("softmax_label",), data_names=("data",)):
    """The weights ``initializer`` gives ``sym`` from ``seed`` on the CPU:
    ({arg: numpy}, {aux: numpy})."""
    pkg.random.seed(seed)
    mod = pkg.mod.Module(sym, context=pkg.cpu(), data_names=data_names,
                         label_names=label_names)
    mod.bind(data_iter.provide_data, data_iter.provide_label)
    mod.init_params(initializer)
    args, auxs = mod.get_params()
    return ({k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in auxs.items()})


def module_delta(after, before):
    """{name: after - before}: the steps a Module's weights took."""
    return {k: after[k] - before[k] for k in before}


def example_first_steps(pkg, ctx, root):
    """Each example's first FIT_STEPS steps on ``ctx`` from weights drawn
    on the CPU: {example: {weight name: the steps it took}} (nce_lm and
    neural_style_toy: each step's loss and the weights, or the image)."""
    out = {}
    np.random.seed(0)
    x, y = fcn_toy_data(96)
    it = pkg.io.NDArrayIter(x, y, batch_size=8, shuffle=True,
                            label_name="softmax_label")
    with pkg.name.NameManager():     # the same auto names on each device
        sym = fcn_toy_symbol(pkg)
    args, auxs = module_init(pkg, sym, it, pkg.init.Xavier())
    out["fcn_toy"] = module_delta(module_steps(
        pkg, ctx, sym, it, args, auxs, "adam", {"learning_rate": 0.01}),
        args)
    xtr, ytr = svm_digits(2048)
    it = pkg.io.NDArrayIter(xtr, ytr, 128, shuffle=True,
                            label_name="svm_label")
    for use_linear, lr in ((False, 1e-3), (True, 1e-2)):
        with pkg.name.NameManager():
            sym = svm_symbol(pkg, use_linear)
        args, auxs = module_init(pkg, sym, it, pkg.init.Uniform(0.01),
                                 label_names=("svm_label",))
        out["svm_mnist use_linear=%s" % use_linear] = module_delta(
            module_steps(pkg, ctx, sym, it, args, auxs, "sgd",
                         {"learning_rate": lr, "momentum": 0.9, "wd": 1e-4},
                         label_names=("svm_label",)), args)
    losses, _, end = nce_lm_main(pkg, ctx, steps=FIT_STEPS)
    out["nce_lm"] = dict(end, losses=np.array(losses))
    losses, img = neural_style_main(pkg, ctx, steps=FIT_STEPS)
    out["neural_style_toy"] = {"losses": np.array(losses), "image": img}
    data, volumes = ndsb2_stacks(8 * FIT_STEPS, np.random.RandomState(7))
    data_csv, label_csv = ndsb2_write_csvs(root, data, volumes)
    it = pkg.io.CSVIter(data_csv=data_csv,
                        data_shape=(NDSB_FRAMES, NDSB_IMG, NDSB_IMG),
                        label_csv=label_csv, label_shape=(NDSB_BINS,),
                        batch_size=8)
    with pkg.name.NameManager():
        sym = ndsb2_lenet(pkg)
    args, auxs = module_init(pkg, sym, it, pkg.init.Uniform(0.01))
    out["train_ndsb2"] = module_delta(module_steps(
        pkg, ctx, sym, it, args, auxs, "sgd",
        {"learning_rate": 0.01, "wd": 0.00001, "momentum": 0.9}), args)
    return out


def examples_phase(mt, card):
    """The five examples the op sweep's ops open, each main on gpu(0) to
    its own asserts, and each one's first steps on the card against the
    CPU (EX_SHARE). Returns {example: seconds}."""
    import tempfile
    gpu = mt.gpu(0)
    secs = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.time()
        firsts = {}
        for label, ctx in (("gpu", gpu), ("cpu", mt.cpu())):
            with ctx:
                firsts[label] = example_first_steps(mt, ctx, root)
        for ex, got in firsts["gpu"].items():
            want = firsts["cpu"][ex]
            top = max(float(np.abs(w).max()) for w in want.values())
            worst = 0.0
            for k, w in want.items():
                w = np.asarray(w, np.float64)
                err = float(np.abs(np.asarray(got[k], np.float64) - w).max()
                            ) / max(float(np.abs(w).max()), EX_FLOOR * top,
                                    1e-30)
                worst = max(worst, err)
                if not err <= EX_SHARE:
                    fail("%s: %s after %d steps on gpu(0) differs from the "
                         "CPU's by %.3g of its largest value (limit %g)"
                         % (ex, k, FIT_STEPS, err, EX_SHARE))
            print("%s: first %d steps on gpu(0) against the CPU: %d arrays "
                  "within %.3g of their largest values (limit %g)"
                  % (ex, FIT_STEPS, len(want), worst, EX_SHARE), flush=True)
        secs["first steps"] = time.time() - t0
        with gpu:
            for ex, run in (
                    ("fcn_toy", lambda: "pixel accuracy %.3f"
                     % fcn_toy_main(mt, gpu)),
                    ("svm_mnist", lambda: "accuracy (squared, linear "
                     "hinge) %.3f, %.3f" % tuple(
                         svm_mnist_main(mt, gpu).values())),
                    ("nce_lm", lambda: "retrieval accuracy %.3f, loss "
                     "%.4f -> %.4f" % (lambda l, a, _: (a, l[0], l[-1]))(
                         *nce_lm_main(mt, gpu))),
                    ("neural_style_toy", lambda: "loss %.4f -> %.4f"
                     % (lambda l, _: (l[0], l[-1]))(
                         *neural_style_main(mt, gpu))),
                    ("train_ndsb2", lambda: "CRPS %.4f (all-half %.4f)"
                     % ndsb2_main(mt, gpu, root))):
                t0 = time.time()
                text = run()
                secs[ex] = time.time() - t0
                print("%s's main on gpu(0): %s, its asserts hold; %.1f s | %s"
                      % (ex, text, secs[ex], card), flush=True)
    return secs



# ---------------------------------------------------------------------------
# FCN-8s on VGG16 (Long, Shelhamer and Darrell, CVPR 2015; Caffe's
# voc-fcn8s, as MXNet v1.x example/fcn-xs/symbol_fcnxs.py get_fcn8s_symbol
# builds it) at full width through Module.fit
# ---------------------------------------------------------------------------

FCN_CLASSES, FCN_IGNORE = 21, 255
FCN_HW, FCN_IMAGES, FCN_EPOCHS = 500, 16, 2   # batch 1, f32
FCN_CHECK_HW = 64                   # the CPU check's image: every crop fits
FCN_CROPS = {"score_pool4c": 5, "score_pool3c": 9, "upscore": 31}
# fcn_xs.py's optimizer: SGD on the unnormalized (summed) pixel loss
FCN_OPT = {"learning_rate": 1e-10, "momentum": 0.99, "wd": 0.0005}
FCN_CAPTURE_STEPS = 2
# the first forward/backward on the card against the CPU (TF32 off), each
# output and gradient within FCN_TOL of its largest value
FCN_TOL = 1e-4
FCN_TIMED_STEPS, FCN_PROFILE_STEPS = 16, 4
VGG16_BLOCKS = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
                (512, 512, 512))


def fcn8s_symbol(pkg, classes=FCN_CLASSES, width_div=1, dropout=0.5):
    """get_fcn8s_symbol: VGG16 (conv1_1 padded by 100, each block closed
    by a 2x2 max pool), fc6 as a 7x7 convolution to 4096 and fc7 as 1x1,
    each with ReLU and dropout; score; score2 = 2x Deconvolution added to
    score_pool4 cropped at 5, score4 = 2x added to score_pool3 cropped at
    9, bigscore = 8x cropped to the data at 31; a per-pixel SoftmaxOutput
    ignoring 255. ``width_div`` narrows every layer (for the CPU tests).
    The upsampling weights are plain variables: fcn8s_init starts them
    as the source does."""
    S = pkg.sym
    data = S.Variable("data")
    x, pools = data, []
    for b, widths in enumerate(VGG16_BLOCKS):
        for i, w in enumerate(widths):
            name = "conv%d_%d" % (b + 1, i + 1)
            pad = (100, 100) if name == "conv1_1" else (1, 1)
            x = S.Convolution(x, kernel=(3, 3), pad=pad,
                              num_filter=w // width_div, name=name)
            x = S.Activation(x, act_type="relu",
                             name="relu%d_%d" % (b + 1, i + 1))
        x = S.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2),
                      name="pool%d" % (b + 1))
        pools.append(x)
    for name, k in (("fc6", 7), ("fc7", 1)):
        x = S.Convolution(x, kernel=(k, k), num_filter=4096 // width_div,
                          name=name)
        x = S.Activation(x, act_type="relu", name="relu" + name[2:])
        x = S.Dropout(x, p=dropout, name="drop" + name[2:])
    score = S.Convolution(x, kernel=(1, 1), num_filter=classes,
                          name="score")

    def up(inp, name, k, s):
        return S.Deconvolution(inp, kernel=(k, k), stride=(s, s),
                               adj=(s - 1, s - 1), num_filter=classes,
                               name=name)

    score2 = up(score, "score2", 4, 2)
    score_pool4 = S.Convolution(pools[3], kernel=(1, 1), num_filter=classes,
                                name="score_pool4")
    fused = score2 + S.Crop(score_pool4, score2, offset=(5, 5),
                            name="score_pool4c")
    score4 = up(fused, "score4", 4, 2)
    score_pool3 = S.Convolution(pools[2], kernel=(1, 1), num_filter=classes,
                                name="score_pool3")
    final = score4 + S.Crop(score_pool3, score4, offset=(9, 9),
                            name="score_pool3c")
    bigscore = up(final, "bigscore", 16, 8)
    upscore = S.Crop(bigscore, data, offset=(31, 31), name="upscore")
    return S.SoftmaxOutput(upscore, multi_output=True, use_ignore=True,
                           ignore_label=FCN_IGNORE, name="softmax")


def fcn8s_layers(sym, hw):
    """Each Convolution / Deconvolution of ``sym`` at a ``hw`` image:
    [(name, op, input shape, weight shape, output shape)], from the
    symbol's own shape inference."""
    internals = sym.get_internals()
    names = internals.list_outputs()
    _, outs, _ = internals.infer_shape(data=(1, 3, hw, hw))
    shapes = dict(zip(names, outs))
    args, _, _ = sym.infer_shape(data=(1, 3, hw, hw))
    arg_shapes = dict(zip(sym.list_arguments(), args))
    graph = json.loads(sym.tojson())
    nodes, layers = graph["nodes"], []
    for n in nodes:
        if n["op"] in ("Convolution", "Deconvolution"):
            src = nodes[n["inputs"][0][0]]
            xin = arg_shapes[src["name"]] if src["op"] == "null" \
                else shapes[src["name"] + "_output"]
            layers.append((n["name"], n["op"], xin,
                           arg_shapes[n["name"] + "_weight"],
                           shapes[n["name"] + "_output"]))
    return layers


def fcn8s_crop_check(sym, hw):
    """Fail unless each Crop's window (its offset, the reference map's
    size) lies inside the map it cuts; returns the windows as text."""
    internals = sym.get_internals()
    _, outs, _ = internals.infer_shape(data=(1, 3, hw, hw))
    shapes = dict(zip(internals.list_outputs(), outs))
    pairs = {"score_pool4c": ("score_pool4", "score2"),
             "score_pool3c": ("score_pool3", "score4"),
             "upscore": ("bigscore", None)}
    text = []
    for crop, off in FCN_CROPS.items():
        src, ref = pairs[crop]
        have = shapes[src + "_output"][2:]
        want = (hw, hw) if ref is None else shapes[ref + "_output"][2:]
        if not all(off + w <= h for w, h in zip(want, have)):
            fail("FCN-8s at %d: crop %s of %s at offset %d does not fit %s"
                 % (hw, crop, want, off, have))
        text.append("%s %dx%d at %d in %dx%d" % (crop, want[0], want[1], off,
                                                 have[0], have[1]))
    return "; ".join(text)


def fcn8s_flops(layers):
    """The FLOPs of one training step from the layers' shapes: each
    convolution's and transposed convolution's multiply-adds (x2) in the
    forward, again for the data gradient (not for the first layer) and
    again for the weight gradient; pooling, ReLU and the loss are left
    out as small beside them. Returns (forward FLOPs, step FLOPs)."""
    fwd = step = 0
    for name, op, xin, w, out in layers:
        if op == "Convolution":
            macs = int(np.prod(out)) * int(np.prod(w[1:]))
        else:                       # weight (C_in, C_out, kh, kw)
            macs = int(np.prod(xin)) * int(np.prod(w[1:]))
        fwd += 2 * macs
        step += 2 * macs * (2 if name == "conv1_1" else 3)
    return fwd, step


def fcn8s_data(n, hw, seed, classes=FCN_CLASSES):
    """``n`` synthetic images with learnable structure: a noisy background
    (class 0) and 1-3 rectangles or discs, each of a class whose colour
    it takes (a fixed palette from the class, plus noise); the label map
    has 255 on a 3-pixel band along each shape's edge, as VOC marks its
    boundaries. Returns (images n x 3 x hw x hw, labels n x hw x hw)."""
    rng = np.random.RandomState(seed)
    palette = np.random.RandomState(1000).uniform(-1, 1, (classes, 3))
    palette[0] = 0.0
    yy, xx = np.mgrid[0:hw, 0:hw]
    x = rng.normal(0, 0.2, (n, 3, hw, hw)).astype(np.float32)
    y = np.zeros((n, hw, hw), np.float32)
    for i in range(n):
        for _ in range(rng.randint(1, 4)):
            c = rng.randint(1, classes)
            cy, cx = rng.randint(hw // 8, hw - hw // 8, 2)
            ry, rx = rng.randint(hw // 12, hw // 4, 2)
            if rng.rand() < 0.5:
                inside = (np.abs(yy - cy) <= ry) & (np.abs(xx - cx) <= rx)
                edge = inside & ~((np.abs(yy - cy) <= ry - 3)
                                  & (np.abs(xx - cx) <= rx - 3))
            else:
                d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
                inside, edge = d <= ry, (d <= ry) & (d > ry - 3)
            x[i][:, inside] = palette[c][:, None] + rng.normal(
                0, 0.2, (3, int(inside.sum())))
            y[i][inside] = c
            y[i][edge] = FCN_IGNORE
    return x, y


class FcnStepStats:
    """A fit's batch_end_callback: each step's mean pixel cross-entropy
    and pixel accuracy over the pixels not labelled 255, from the step's
    outputs, kept on the card until read."""

    def __init__(self):
        self.steps = []             # (epoch, ce, accuracy) 0-dim tensors

    def __call__(self, param):
        import torch
        mod, batch = param.locals["self"], param.locals["batch"]
        prob = mod.get_outputs()[0].data
        label = batch.label[0].data.to(prob.device)
        valid = label != FCN_IGNORE
        lab = torch.where(valid, label, 0).long()
        p = prob.gather(1, lab[:, None])[:, 0].clamp_min(1e-12)
        n = valid.sum().clamp_min(1)
        self.steps.append((param.epoch,
                           -(torch.log(p) * valid).sum() / n,
                           ((prob.argmax(1) == lab) & valid).sum() / n))

    def epoch_means(self):
        by = {}
        for e, ce, acc in self.steps:
            by.setdefault(e, []).append((float(ce), float(acc)))
        return [tuple(np.mean(by[e], axis=0)) for e in sorted(by)]


def fcn8s_iter(pkg, x, y, shuffle):
    return pkg.io.NDArrayIter(x, y, batch_size=1, shuffle=shuffle,
                              label_name="softmax_label")


FCN_UPSAMPLE = ("score2_weight", "score4_weight", "bigscore_weight")


def fcn8s_upsample(shape):
    """An upsampling weight (C_in, C_out, k, k) as the source starts it
    (voc-fcn8s's surgery.interp, fcn-xs's init_fcnxs): the Bilinear
    initializer's kernel from each class to itself, zeros between
    classes. (Bilinear itself fills every channel pair with the kernel,
    which gives every class the same score.)"""
    k = shape[3]
    f = np.ceil(k / 2.0)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    ramp = 1 - np.abs(np.arange(k) / f - c)
    w = np.zeros(shape, np.float32)
    for i in range(min(shape[0], shape[1])):
        w[i, i] = np.outer(ramp[:shape[2]], ramp)
    return w


def fcn8s_init(pkg, sym, hw, seed):
    """FCN-8s's weights from ``seed`` on the CPU: Xavier, the upsampling
    weights as fcn8s_upsample starts them. {name: numpy}."""
    x, y = fcn8s_data(1, hw, seed)
    args = module_init(pkg, sym, fcn8s_iter(pkg, x, y, False),
                       pkg.init.Xavier(), seed)[0]
    for name in FCN_UPSAMPLE:
        args[name] = fcn8s_upsample(args[name].shape)
    return args


def fcn8s_fit(pkg, sym, x, y, ctx, epochs, arg_params=None, callback=None,
              kvstore="local"):
    """FCN-8s through Module.fit on ``ctx`` as fcn_xs.py fits it (SGD at
    FCN_OPT, Xavier; batch 1), its pixel accuracy in a metric list as
    fit.py passes one (updated after the step, so the captured step has
    one signature). Returns (the module, its iterator)."""
    it = fcn8s_iter(pkg, x, y, True)
    mod = pkg.mod.Module(sym, context=ctx)
    mod.fit(it, optimizer="sgd", optimizer_params=dict(FCN_OPT),
            initializer=pkg.init.Xavier(), num_epoch=epochs,
            arg_params=None if arg_params is None
            else host_params(pkg, arg_params), kvstore=kvstore,
            batch_end_callback=callback, eval_metric=["acc"])
    return mod, it


def fcn8s_card_check(mt, sym, seed):
    """The first forward and backward at FCN_CHECK_HW (TF32 off) on
    gpu(0) against the CPU from the same weights: the softmax and every
    weight's gradient, each within FCN_TOL of its largest value."""
    import torch
    args = fcn8s_init(mt, sym, FCN_CHECK_HW, seed)
    x, y = fcn8s_data(1, FCN_CHECK_HW, seed + 1)
    got = {}
    for label, ctx in (("gpu", mt.gpu(0)), ("cpu", mt.cpu())):
        with ctx:
            np.random.seed(seed)    # the executor's generator: the dropout
            ex = sym.simple_bind(ctx, data=x.shape,      # masks, drawn alike
                                 softmax_label=y.shape)
            for k, v in ex.arg_dict.items():
                v[:] = {"data": x, "softmax_label": y}.get(k, args.get(k))
            out = ex.forward(is_train=True)[0].asnumpy()
            ex.backward()
            got[label] = dict(
                {k: g.asnumpy() for k, g in ex.grad_dict.items()
                 if g is not None and k in args}, softmax=out)
    worst = 0.0
    for k, want in got["cpu"].items():
        have = got["gpu"][k]
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(have - want).max()) / scale
        worst = max(worst, err)
        if not err <= FCN_TOL:
            fail("FCN-8s at %d: %s on gpu(0) differs from the CPU by %.3g "
                 "of its largest value (limit %g)" % (FCN_CHECK_HW, k, err,
                                                      FCN_TOL))
    return worst, len(got["cpu"])


def fcn8s_capture_check(mt, seed):
    """FCN_CAPTURE_STEPS captured steps against eager ones on the card
    from the same weights, at full size, under deterministic cuDNN, with
    the dropout layers at p=0 (eager steps draw their masks from another
    generator than the captured step's). Returns the largest difference
    in the weights, relative to each weight's largest step."""
    import torch
    sym = fcn8s_symbol(mt, dropout=0.0)
    args = fcn8s_init(mt, sym, FCN_HW, seed)
    x, y = fcn8s_data(FCN_CAPTURE_STEPS, FCN_HW, seed + 2)
    got = {}
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for fused in (False, True):
            np.random.seed(seed)
            mod, _ = with_fused(fused, fcn8s_fit, mt, sym, x, y, mt.gpu(0),
                                1, arg_params=args)
            if fused:
                capture_report(mod, FCN_CAPTURE_STEPS, "FCN-8s")
            got[fused] = module_params(mod)
            del mod
    finally:
        torch.backends.cudnn.deterministic = old
    worst = 0.0
    for k, w0 in args.items():
        step = float(np.abs(got[False][k] - w0).max())
        diff = float(np.abs(got[True][k] - got[False][k]).max())
        if diff > max(1e-3 * step, 1e-12):
            fail("FCN-8s: %s after %d captured steps differs from the "
                 "eager steps by %.3g (its largest step %.3g)"
                 % (k, FCN_CAPTURE_STEPS, diff, step))
        worst = max(worst, diff / step if step else 0.0)
    return worst


def fcn8s_deconv_ms(mt, layers):
    """Card ms of each Deconvolution of the step at its own shapes:
    forward alone and forward + backward (data and weight gradients)."""
    import torch
    from mxtpu_torch.ops.registry import get_op
    deconv = get_op("Deconvolution").fn
    out = {}
    for name, op, xin, w, _ in layers:
        if op != "Deconvolution":
            continue
        k, s = w[2], {4: 2, 16: 8}[w[2]]
        x = torch.randn(xin, device="cuda", requires_grad=True)
        wt = torch.randn(w, device="cuda", requires_grad=True)
        kw = dict(kernel=(k, k), stride=(s, s), adj=(s - 1, s - 1),
                  num_filter=w[1])
        fwd = cuda_ms(lambda: deconv(x, wt, **kw), iters=20)

        def both():
            y = deconv(x, wt, **kw)
            torch.autograd.grad(y, (x, wt), torch.ones_like(y))
        out[name] = (fwd, cuda_ms(both, iters=20))
    return out


def fcn8s_phase(mt, seed, card):
    """FCN-8s on VGG16 at full width (500x500, batch 1, 21 classes, f32)
    through Module.fit on gpu(0): the crops inside their maps; the first
    forward/backward at FCN_CHECK_HW against the CPU (TF32 off); captured
    steps against eager ones; then FCN_EPOCHS epochs of FCN_IMAGES
    synthetic images eager and captured under torch's default TF32 (the
    loss falls, the pixel accuracy rises), both timed in turns beside the
    bound from the layers' FLOPs, with the busy share, the three
    Deconvolutions' card time and the peak memory. Returns {path: ms}."""
    import gc
    import torch
    gpu = mt.gpu(0)
    clock = [("start", time.perf_counter())]
    sym = fcn8s_symbol(mt)
    windows = fcn8s_crop_check(sym, FCN_HW)
    check_windows = fcn8s_crop_check(sym, FCN_CHECK_HW)
    layers = fcn8s_layers(sym, FCN_HW)
    fwd_flops, step_flops = fcn8s_flops(layers)
    n_param = sum(int(np.prod(s)) for s, n in zip(
        sym.infer_shape(data=(1, 3, FCN_HW, FCN_HW))[0],
        sym.list_arguments()) if n not in ("data", "softmax_label"))
    print("FCN-8s on VGG16 at %dx%d: %d weights; crops %s (at %d: %s); "
          "%.4g FLOPs a forward, %.4g a training step (from the layers' "
          "shapes) | %s" % (FCN_HW, FCN_HW, n_param, windows, FCN_CHECK_HW,
                            check_windows, fwd_flops, step_flops, card),
          flush=True)
    worst, n = fcn8s_card_check(mt, sym, seed)
    print("FCN-8s first forward/backward at %dx%d (TF32 off) on gpu(0) "
          "against the CPU: softmax and %d gradients within %.3g of their "
          "largest values (limit %g)" % (FCN_CHECK_HW, FCN_CHECK_HW, n - 1,
                                         worst, FCN_TOL), flush=True)
    clock.append(("first step", time.perf_counter()))
    worst = fcn8s_capture_check(mt, seed)
    print("FCN-8s: %d captured steps against eager ones at %dx%d "
          "(deterministic cuDNN, dropout p=0): weights within %.3g of their "
          "largest step" % (FCN_CAPTURE_STEPS, FCN_HW, FCN_HW, worst),
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    clock.append(("capture check", time.perf_counter()))

    x, y = fcn8s_data(FCN_IMAGES, FCN_HW, seed)
    args = fcn8s_init(mt, sym, FCN_HW, seed)
    runs, stats = {}, {}
    with tf32_mode(True):
        for path, fused in (("eager", False), ("captured", True)):
            torch.cuda.reset_peak_memory_stats()
            stats[path] = FcnStepStats()
            np.random.seed(seed)
            mt.random.seed(seed)
            t0 = time.perf_counter()
            mod, it = with_fused(fused, fcn8s_fit, mt, sym, x, y, gpu,
                                 FCN_EPOCHS, arg_params=args,
                                 callback=[stats[path]])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            text = "eager"
            if fused:
                text = capture_report(mod, FCN_EPOCHS * FCN_IMAGES,
                                      "FCN-8s")[0]
            means = stats[path].epoch_means()
            ce = [m[0] for m in means]
            acc = [m[1] for m in means]
            if not (np.isfinite(ce).all() and ce[-1] < ce[0]
                    and acc[-1] > acc[0]):
                fail("FCN-8s %s fit: pixel cross-entropy by epoch %s, pixel "
                     "accuracy %s (the loss must fall, the accuracy rise)"
                     % (path, ce, acc))
            print("FCN-8s Module.fit %s (cuDNN TF32 on): %d epochs of %d "
                  "images at %dx%d, batch 1, in %.2f s; pixel cross-entropy "
                  "by epoch %s, pixel accuracy (without 255) %s; %s; peak "
                  "memory %.2f GB | %s"
                  % (path, FCN_EPOCHS, FCN_IMAGES, FCN_HW, FCN_HW, secs,
                     ", ".join("%.4f" % v for v in ce),
                     ", ".join("%.4f" % v for v in acc), text,
                     torch.cuda.max_memory_allocated() / 1e9, card),
                  flush=True)
            runs[path] = (mod, it)
        clock.append(("fits", time.perf_counter()))
        # the steps in turns (eager, captured, captured, eager)
        metrics = {k: mt.metric.create("acc") for k in runs}
        ms = {k: [] for k in runs}
        for k in ("eager", "captured", "captured", "eager"):
            mod, it = runs[k]
            it.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps = fit_steps(mod, it, metrics[k], steps=FCN_TIMED_STEPS)[1]
            torch.cuda.synchronize()
            ms[k].append((time.perf_counter() - t0) / steps * 1e3)
        bound = step_flops / PEAK_TF32 * 1e3
        out = {}
        for k, (mod, it) in runs.items():
            step = float(np.mean(ms[k]))
            out[k] = step
            it.reset()
            busy, top = device_time(lambda: fit_steps(
                mod, it, metrics[k], steps=FCN_PROFILE_STEPS), 1,
                per=FCN_PROFILE_STEPS)
            print("FCN-8s %s step (cuDNN TF32 on): %.3f ms (%s), %.1f "
                  "images/s; bound %.3f ms (%.4g FLOPs at TF32's %.0f "
                  "TFLOP/s; operations), %.1f%% of it; %s; per step: %s | %s"
                  % (k, step, ", ".join("%.3f" % v for v in ms[k]),
                     1e3 / step, bound, step_flops, PEAK_TF32 / 1e12,
                     100 * bound / step, busy_of(busy, step), top, card),
                  flush=True)
        deconv = fcn8s_deconv_ms(mt, layers)
    print("FCN-8s Deconvolutions' card time (cuDNN TF32 on), ms forward / "
          "forward + backward: %s | %s" % (", ".join(
              "%s %.4f / %.4f" % ((k,) + v) for k, v in deconv.items()),
              card))
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    clock.append(("timings", time.perf_counter()))
    print("FCN-8s phase: %.1f s (%s)" % (
        clock[-1][1] - clock[0][1], ", ".join(
            "%s %.1f" % (name, t - clock[i][1])
            for i, (name, t) in enumerate(clock[1:]))), flush=True)
    return out


# ---------------------------------------------------------------------------
# Attention beyond flash: example/char_lm/char_lm.py and
# example/moe_transformer/moe_transformer.py, each mirrored with ``pkg``
# for mxtpu and the context a parameter where the example hard-codes cpu()
# (the examples import mxtpu); the char LM's generate half through the
# port's GenerateScheduler (the example's ModelServer / ServingClient hop
# waits for the port of the server)
# ---------------------------------------------------------------------------

CL_TEXT = "the quick brown fox jumps over the lazy dog. " * 40
CL_CHARS = sorted(set(CL_TEXT))
CL_C2I = {c: i for i, c in enumerate(CL_CHARS)}
CL_VOCAB = len(CL_CHARS)
CL_ARGS = dict(dim=32, heads=2, layers=2, seq_len=48, cache_len=64,
               epochs=8, batch_size=32)       # the example's defaults
CL_SEED, CL_NEW = "the quick brown ", 40
CL_WANT = "fox jumps over the lazy dog."
MOE_V, MOE_D, MOE_H, MOE_E, MOE_FF = 16, 32, 2, 8, 16
MOE_T, MOE_PERIOD, MOE_EPOCHS = 16, 4, 20
# a key's bias shifts every score of a query row alike, which the softmax
# ignores: its gradient is rounding alone
A7_NO_GRAD = ("_k_bias",)


def char_lm_build(pkg, dim, heads, layers, cache_len, vocab=CL_VOCAB):
    """char_lm.py's build_lm: one stack, the TRAIN graph with zero-fed
    caches of length T, the GEN graph with a bigger cache and the
    ``*_next`` outputs."""
    data = pkg.sym.Variable("data")
    pos = pkg.sym.Variable("pos", shape=(0,), dtype="int32")
    x = pkg.sym.Embedding(data=data, input_dim=vocab, output_dim=dim,
                          name="tok_emb")
    cache_next = []
    for li in range(layers):
        kc = pkg.sym.Variable("kc%d" % li, shape=(0, cache_len, dim))
        vc = pkg.sym.Variable("vc%d" % li, shape=(0, cache_len, dim))
        q = pkg.sym.FullyConnected(data=x, num_hidden=dim, flatten=False,
                                   name="l%d_q" % li)
        k = pkg.sym.FullyConnected(data=x, num_hidden=dim, flatten=False,
                                   name="l%d_k" % li)
        v = pkg.sym.FullyConnected(data=x, num_hidden=dim, flatten=False,
                                   name="l%d_v" % li)
        att = pkg.sym.cached_attention(q, k, v, kc, vc, pos,
                                       num_heads=heads, alibi=True,
                                       name="l%d_att" % li)
        o = pkg.sym.FullyConnected(data=att[0], num_hidden=dim,
                                   flatten=False, name="l%d_o" % li)
        x = x + o
        f = pkg.sym.FullyConnected(data=x, num_hidden=2 * dim,
                                   flatten=False, name="l%d_f1" % li)
        f = pkg.sym.Activation(f, act_type="relu")
        f = pkg.sym.FullyConnected(data=f, num_hidden=dim, flatten=False,
                                   name="l%d_f2" % li)
        x = x + f
        cache_next.append(pkg.sym.identity(att[1], name="kc%d_next" % li))
        cache_next.append(pkg.sym.identity(att[2], name="vc%d_next" % li))
    logits = pkg.sym.FullyConnected(data=x, num_hidden=vocab,
                                    flatten=False, name="head")
    return logits, cache_next


def char_lm_train_symbol(pkg, dim, heads, layers, seq_len, vocab=CL_VOCAB):
    logits, _ = char_lm_build(pkg, dim, heads, layers, seq_len, vocab)
    flat = pkg.sym.Reshape(logits, shape=(-1, vocab))
    return pkg.sym.SoftmaxOutput(flat, name="softmax")


def char_lm_gen_symbol(pkg, dim, heads, layers, cache_len, vocab=CL_VOCAB):
    logits, cache_next = char_lm_build(pkg, dim, heads, layers, cache_len,
                                       vocab)
    return pkg.sym.Group([logits] + cache_next)


def char_lm_feed(seq_len, dim, layers):
    """char_lm.py's sliding next-char windows: ({input: array}, labels)."""
    ids = np.asarray([CL_C2I[c] for c in CL_TEXT], np.int32)
    starts = np.arange(0, len(ids) - seq_len - 1, 3)
    X = np.stack([ids[s:s + seq_len] for s in starts]).astype("f")
    Y = np.stack([ids[s + 1:s + seq_len + 1] for s in starts]).astype("f")
    feed = {"data": X, "pos": np.zeros((len(X),), "f")}
    for li in range(layers):
        feed["kc%d" % li] = np.zeros((len(X), seq_len, dim), "f")
        feed["vc%d" % li] = np.zeros((len(X), seq_len, dim), "f")
    return feed, Y


def char_lm_train(pkg, ctx, prefix, dim=32, heads=2, layers=2, seq_len=48,
                  cache_len=64, epochs=8, batch_size=32):
    """char_lm.py's main up to the checkpoint, on ``ctx``: Module.fit of the
    TRAIN symbol (the example's Adam and Xavier), its perplexity assert,
    the GEN symbol saved with the trained weights. Returns (module,
    perplexity)."""
    os.environ.setdefault("MXTPU_PS_HEARTBEAT", "0")
    pkg.random.seed(0)
    np.random.seed(0)
    T, D = seq_len, dim
    feed, Y = char_lm_feed(T, D, layers)
    it = pkg.io.NDArrayIter(feed, {"softmax_label": Y},
                            batch_size=batch_size, shuffle=True)
    mod = pkg.mod.Module(char_lm_train_symbol(pkg, D, heads, layers, T),
                         context=ctx, data_names=sorted(feed),
                         label_names=["softmax_label"])
    mod.fit(it, num_epoch=epochs, optimizer="adam",
            optimizer_params={"learning_rate": 3e-3},
            initializer=pkg.init.Xavier(),
            eval_metric=pkg.metric.Perplexity(ignore_label=None))
    it.reset()
    ppl = dict(mod.score(
        it, pkg.metric.Perplexity(ignore_label=None)))["perplexity"]
    assert ppl < 1.35, "corpus not learned (perplexity %.3f)" % ppl
    arg_params, aux_params = mod.get_params()
    pkg.model.save_checkpoint(
        prefix, 0, char_lm_gen_symbol(pkg, D, heads, layers, cache_len),
        arg_params, aux_params)
    return mod, ppl


def generate(sched, prompt, max_new, **kw):
    """One sequence through a GenerateScheduler: (tokens, reply info)."""
    req = sched.submit("r%d" % id(prompt), prompt, max_new, **kw)
    if isinstance(req, tuple):
        raise RuntimeError("generate refused: %r" % (req,))
    verdict, info = req.wait()
    if verdict != "ok":
        raise RuntimeError("generate failed: %s %s" % (verdict, info))
    return [int(t) for t in info["tokens"]], info


def char_lm_serve(mt, prefix, ctx, slots=None):
    """char_lm.py's serving half through the port's GenerateScheduler: the
    GEN checkpoint loaded by InferenceEngine.from_checkpoint on ``ctx``,
    greedy decode of the memorized text, a second sequence with the same
    tokens and no new program. Returns (text, engine, scheduler stats)."""
    from mxtpu_torch.serving import GenerateScheduler, InferenceEngine
    engine = InferenceEngine.from_checkpoint(prefix, 0, {"data": (1,)},
                                             buckets=(1,), ctx=ctx)
    assert engine.is_generative, "gen symbol must declare the KV contract"
    sched = GenerateScheduler(engine, 64, slots=slots)
    try:
        prompt = np.asarray([CL_C2I[c] for c in CL_SEED], np.int32)
        toks, info = generate(sched, prompt, CL_NEW)
        text = "".join(CL_CHARS[t] for t in toks)
        assert text.startswith(CL_WANT), \
            "memorized corpus not reproduced: %r" % text
        before = engine.cache.compiles
        toks2, _ = generate(sched, prompt, CL_NEW)
        assert toks2 == toks, "greedy decode must be deterministic"
        assert engine.cache.compiles == before, \
            "decode retraced (%d -> %d compiles)" \
            % (before, engine.cache.compiles)
        return text, engine, sched.stats()
    finally:
        sched.stop()


def moe_build_model(pkg, seq_len):
    """moe_transformer.py's build_model: 2 x cached_attention, the MoE FFN
    (8 experts, top-1, capacity factor 2), the head."""
    D = MOE_D
    data = pkg.sym.Variable("data")
    pos = pkg.sym.Variable("pos", shape=(0,), dtype="int32")
    x = pkg.sym.Embedding(data=data, input_dim=MOE_V, output_dim=D,
                          name="tok_emb")
    for li in range(2):
        kc = pkg.sym.Variable("kc%d" % li, shape=(0, seq_len, D))
        vc = pkg.sym.Variable("vc%d" % li, shape=(0, seq_len, D))
        q = pkg.sym.FullyConnected(data=x, num_hidden=D, flatten=False,
                                   name="l%d_q" % li)
        k = pkg.sym.FullyConnected(data=x, num_hidden=D, flatten=False,
                                   name="l%d_k" % li)
        v = pkg.sym.FullyConnected(data=x, num_hidden=D, flatten=False,
                                   name="l%d_v" % li)
        att = pkg.sym.cached_attention(q, k, v, kc, vc, pos,
                                       num_heads=MOE_H, alibi=True,
                                       name="l%d_att" % li)
        o = pkg.sym.FullyConnected(data=att[0], num_hidden=D,
                                   flatten=False, name="l%d_o" % li)
        x = x + o
    gate = pkg.sym.Variable("moe_gate", shape=(D, MOE_E))
    w1 = pkg.sym.Variable("moe_w1", shape=(MOE_E, D, MOE_FF))
    b1 = pkg.sym.Variable("moe_b1", shape=(MOE_E, MOE_FF))
    w2 = pkg.sym.Variable("moe_w2", shape=(MOE_E, MOE_FF, D))
    b2 = pkg.sym.Variable("moe_b2", shape=(MOE_E, D))
    moe = pkg.sym.moe_ffn(x, gate, w1, b1, w2, b2, capacity_factor=2.0,
                          num_selected=1, name="moe")
    x = x + moe[0]
    logits = pkg.sym.FullyConnected(data=x, num_hidden=MOE_V,
                                    flatten=False, name="head")
    flat = pkg.sym.Reshape(logits, shape=(-1, MOE_V))
    return pkg.sym.SoftmaxOutput(flat, name="softmax")


def moe_init_params(pkg, seed=11):
    """moe_transformer.py's explicit init of the declared MoE vars."""
    D, E, FF = MOE_D, MOE_E, MOE_FF
    rng = np.random.RandomState(seed)
    s = 0.1
    host = {"moe_gate": rng.randn(D, E).astype(np.float32) * s,
            "moe_w1": rng.randn(E, D, FF).astype(np.float32) * s,
            "moe_b1": np.zeros((E, FF), np.float32),
            "moe_w2": rng.randn(E, FF, D).astype(np.float32) * s,
            "moe_b2": np.zeros((E, D), np.float32)}
    return {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in host.items()}


def moe_stream_batches(n=256, seed=3):
    """moe_transformer.py's periodic token stream."""
    T = MOE_T
    rng = np.random.RandomState(seed)
    head = rng.randint(0, MOE_V, size=(n, MOE_PERIOD))
    reps = (T + 1 + MOE_PERIOD - 1) // MOE_PERIOD + 1
    full = np.tile(head, (1, reps))[:, :T + 1]
    return full[:, :T].astype("f"), full[:, 1:].astype("f")


def moe_feed(X):
    feed = {"data": X, "pos": np.zeros((len(X),), "f")}
    for li in range(2):
        feed["kc%d" % li] = np.zeros((len(X), MOE_T, MOE_D), "f")
        feed["vc%d" % li] = np.zeros((len(X), MOE_T, MOE_D), "f")
    return feed


def moe_train(pkg, ctx, epochs=6):
    """moe_transformer.py's train() on one device (``ctx``; the mesh
    waits for the port of the mesh layer). Returns (module, perplexity,
    {name: numpy})."""
    np.random.seed(0)
    pkg.random.seed(0)
    X, Y = moe_stream_batches()
    feed = moe_feed(X)
    it = pkg.io.NDArrayIter(feed, {"softmax_label": Y}, batch_size=32,
                            shuffle=True)
    mod = pkg.mod.Module(moe_build_model(pkg, MOE_T), context=ctx,
                         data_names=sorted(feed),
                         label_names=["softmax_label"])
    mod.fit(it, num_epoch=epochs, optimizer="adam",
            optimizer_params={"learning_rate": 1e-2},
            initializer=pkg.init.Xavier(),
            arg_params=moe_init_params(pkg), allow_missing=True,
            eval_metric=pkg.metric.Perplexity(ignore_label=None))
    it.reset()
    ppl = dict(mod.score(
        it, pkg.metric.Perplexity(ignore_label=None)))["perplexity"]
    args, _auxs = mod.get_params()
    return mod, ppl, {k: v.asnumpy().copy() for k, v in args.items()}


def moe_engine(pkg, host, ctx=None):
    """moe_transformer.py's unsharded engine e0 (buckets 1 and 8) over
    ``host`` weights, and the feed of its parity request."""
    shapes = {"data": (MOE_T,), "pos": ()}
    for li in range(2):
        shapes["kc%d" % li] = (MOE_T, MOE_D)
        shapes["vc%d" % li] = (MOE_T, MOE_D)
    kw = {} if ctx is None else {"ctx": ctx}
    eng = pkg.serving.InferenceEngine(moe_build_model(pkg, MOE_T), host, {},
                                      shapes, buckets=(1, 8), warm=True,
                                      **kw)
    x = moe_stream_batches(n=8, seed=9)[0]
    zeros = {"pos": np.zeros((len(x),), np.int32), "data": x}
    for li in range(2):
        zeros["kc%d" % li] = np.zeros((len(x), MOE_T, MOE_D), "f")
        zeros["vc%d" % li] = np.zeros((len(x), MOE_T, MOE_D), "f")
    return eng, [zeros[n] for n in sorted(shapes)]


def a7_first_fits(pkg, ctx, steps=FIT_STEPS, inits=None):
    """Each TRAIN symbol's first ``steps`` steps through Module.fit (the
    fused step where it engages: on the card captured from its second
    signature's second step) on ``ctx`` from weights drawn on the CPU (or
    ``inits``: {symbol: {weight: numpy}}), over the first ``steps``
    batches unshuffled: {symbol: {weight: the steps it took}}, with each
    symbol's learning rate, whether its fit ran fused, and the weights
    it started from."""
    out = {}
    cl = CL_ARGS
    feed, Y = char_lm_feed(cl["seq_len"], cl["dim"], cl["layers"])
    with pkg.name.NameManager():
        sym = char_lm_train_symbol(pkg, cl["dim"], cl["heads"],
                                   cl["layers"], cl["seq_len"])
    n = steps * cl["batch_size"]
    it = pkg.io.NDArrayIter({k: v[:n] for k, v in feed.items()},
                            {"softmax_label": Y[:n]},
                            batch_size=cl["batch_size"])
    args, _ = module_init(pkg, sym, it, pkg.init.Xavier(),
                          data_names=sorted(feed))
    out["char_lm"] = (sym, it, args, 3e-3, sorted(feed))
    X, Y = moe_stream_batches()
    feed = moe_feed(X)
    with pkg.name.NameManager():
        sym = moe_build_model(pkg, MOE_T)
    n = steps * 32
    it = pkg.io.NDArrayIter({k: v[:n] for k, v in feed.items()},
                            {"softmax_label": Y[:n]}, batch_size=32)
    pkg.random.seed(0)
    mod = pkg.mod.Module(sym, context=pkg.cpu(), data_names=sorted(feed))
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(pkg.init.Xavier(), arg_params=moe_init_params(pkg),
                    allow_missing=True)
    args = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    out["moe_transformer"] = (sym, it, args, 1e-2, sorted(feed))
    steps_taken = {}
    for name, (sym, it, args, lr, data_names) in out.items():
        if inits is not None:
            args = inits[name]
        steps_taken[name + " lr"] = lr
        steps_taken[name + " init"] = args
        pkg.random.seed(0)
        np.random.seed(0)
        it.reset()
        mod = pkg.mod.Module(sym, context=ctx, data_names=data_names,
                             label_names=["softmax_label"])
        mod.fit(it, num_epoch=1, optimizer="adam",
                optimizer_params={"learning_rate": lr},
                arg_params=host_params(pkg, args),
                eval_metric=pkg.metric.Perplexity(ignore_label=None))
        got = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        steps_taken[name] = module_delta(got, args)
        steps_taken[name + " fused"] = getattr(mod, "_fused", None) \
            is not None
    return steps_taken


def gen_graphs(engine):
    """Fail unless every prefill and decode program ``engine`` built runs
    as a captured CUDA graph over tensors on the card (no program of the
    card takes a path of the CPU's). Returns how many there are."""
    import torch
    from mxtpu_torch.module.fused import GraphProgram
    progs = [e for e in engine.cache.entries()
             if isinstance(e, GraphProgram)]
    if not torch.cuda.is_available():
        return len(progs)
    bad = [p.name for p in progs if p.graph is None or not all(
        t.is_cuda for t in p.params)]
    if not progs or bad:
        fail("generation programs not captured on the card: %s of %d"
             % (bad, len(progs)))
    return len(progs)


def capture_fault_check(mt):
    """A generation program whose body waits for the card cannot be
    captured: its capture must raise (no eager fallback), and the card
    must work after it."""
    import torch
    from mxtpu_torch.module.fused import GraphProgram
    dev = torch.device("cuda", 0)
    x = torch.ones(4, device=dev)
    prog = GraphProgram("probe", lambda: x * float(x.sum().item()), dev,
                         (), torch.cuda.Stream(device=dev))
    prog()                          # the first call runs for real
    try:
        prog()
    except RuntimeError as e:
        if "could not be captured" not in str(e):
            raise
    else:
        fail("a generation program that reads the card was captured")
    if float((x * 2).sum().item()) != 8.0:
        fail("the card misbehaves after a failed capture")


def a7_phase(mt, card):
    """Phase 24: the examples cached_attention and moe_ffn open, on gpu(0)
    at their own widths. Each TRAIN symbol's first FIT_STEPS fused steps
    against the CPU's (EX_SHARE); char_lm's main (the fused fit,
    perplexity < 1.35, the GEN checkpoint) and its generate half through
    GenerateScheduler (the memorized text, the same tokens twice, no new
    capture); moe_transformer's train() to perplexity < 2.5 and its
    unsharded engine e0 against the CPU's (1e-5), a weight swap building
    nothing. Returns {part: seconds}."""
    import tempfile
    import torch
    gpu = mt.gpu(0)
    secs = {}
    t0 = time.time()
    firsts = {}
    for label, ctx in (("gpu", gpu), ("cpu", mt.cpu())):
        with ctx:
            firsts[label] = a7_first_fits(mt, ctx)
    for ex in ("char_lm", "moe_transformer"):
        if not firsts["gpu"][ex + " fused"]:
            fail("%s: the fused Module step did not engage on gpu(0)" % ex)
        got, want = firsts["gpu"][ex], firsts["cpu"][ex]
        lr = firsts["cpu"][ex + " lr"]
        top = max(float(np.abs(w).max()) for w in want.values())
        worst, bad, unsteered = 0.0, [], []
        for k, w in want.items():
            if k.endswith(A7_NO_GRAD):
                # no gradient but rounding's: Adam steps by the sign of
                # noise, at most lr a step on either device
                step = max(float(np.abs(got[k]).max()),
                           float(np.abs(w).max()))
                unsteered.append(k)
                if not step <= FIT_STEPS * lr * (1 + 1e-3):
                    bad.append("%s stepped %.3g" % (k, step))
                continue
            err = float(np.abs(got[k] - w).max()) / max(
                float(np.abs(w).max()), EX_FLOOR * top, 1e-30)
            worst = max(worst, err)
            if not err <= EX_SHARE:
                bad.append("%s by %.3g" % (k, err))
        if bad:
            fail("%s: after %d fused steps on gpu(0) weights differ from "
                 "the CPU's (limit %g of the largest step): %s"
                 % (ex, FIT_STEPS, EX_SHARE, "; ".join(bad)))
        print("%s: first %d fused Module.fit steps (captured on gpu(0)) "
              "against the CPU: %d weights within %.3g of their largest "
              "steps (limit %g); %d key biases (no gradient: softmax "
              "ignores a shift common to a row's scores) within Adam's "
              "%d x lr" % (ex, FIT_STEPS, len(want) - len(unsteered), worst,
                          EX_SHARE, len(unsteered), FIT_STEPS), flush=True)
    secs["first steps"] = time.time() - t0
    if torch.cuda.is_available():
        capture_fault_check(mt)
        print("a generation program that reads the card mid-capture: its "
              "capture raised, the card worked after it", flush=True)
    with tempfile.TemporaryDirectory() as root, gpu:
        t0 = time.time()
        prefix = os.path.join(root, "char_lm")
        mod, ppl = char_lm_train(mt, gpu, prefix, **CL_ARGS)
        if mod._fused is None or mod._fused._group.stats["fallbacks"]:
            fail("char_lm: Module.fit did not run the captured step "
                 "(%s)" % getattr(mod, "_fused_fallback_logged", None))
        fit_stats = dict(mod._fused._group.stats)
        text, engine, sched = char_lm_serve(mt, prefix, gpu)
        graphs = gen_graphs(engine)
        secs["char_lm"] = time.time() - t0
        print("char_lm's main on gpu(0): perplexity %.4f (< 1.35) through "
              "the fused Module.fit (%d steps, %d compiles, %d fallbacks); "
              "the GEN checkpoint served by GenerateScheduler: %r, the same "
              "tokens twice; engine %s, %d generation programs, each a CUDA "
              "graph; scheduler %d sequences, %d decode steps, %d tokens; "
              "%.1f s | %s"
              % (ppl, fit_stats["steps"], fit_stats["compiles"],
                 fit_stats["fallbacks"], text, engine.cache.stats(), graphs,
                 sched["sequences"], sched["steps"], sched["tokens"],
                 secs["char_lm"], card), flush=True)
        t0 = time.time()
        mod, ppl, host = moe_train(mt, gpu, epochs=MOE_EPOCHS)
        if mod._fused is None:
            fail("moe_transformer: the fused Module step did not engage")
        assert ppl < 2.5, "MoE did not learn the stream (%.3f)" % ppl
        e0, feed = moe_engine(mt, host, gpu)
        e_cpu, _ = moe_engine(mt, host, mt.cpu())
        o0 = e0.predict(feed)[0]
        d = float(np.max(np.abs(o0 - e_cpu.predict(feed)[0])))
        if not d < 1e-5:
            fail("moe_transformer: e0 on gpu(0) differs from the CPU's by "
                 "%.3g (limit 1e-5)" % d)
        compiles = e0.stats()["compiles"]
        e0.predict(feed)
        v = e0.swap_weights(host)
        if not (v == 1 and e0.stats()["compiles"] == compiles):
            fail("moe_transformer: swap_weights built programs (%s)"
                 % e0.stats())
        secs["moe_transformer"] = time.time() - t0
        print("moe_transformer's train() on gpu(0): perplexity %.4f (< 2.5) "
              "after %d epochs; e0 (buckets 1, 8) against the CPU's: max "
              "|diff| %.3g (limit 1e-5); %d programs, none built by "
              "swap_weights; %.1f s | %s"
              % (ppl, MOE_EPOCHS, d, compiles, secs["moe_transformer"],
                 card), flush=True)
    torch.cuda.empty_cache()
    return secs


# ---------------------------------------------------------------------------
# Full width: char_lm's build_lm at the widths of the ALiBi paper's
# WikiText-103 model (Press, Smith and Lewis, arXiv:2108.12409, section 4,
# after Baevski and Auli): 16 layers, d = 1024, 8 heads, trained on windows
# of 512, served with a cache of 1,024 (the paper's extrapolation to 2L),
# vocabulary 267,735, f32. build_lm's own block stays: FFN 2d, ReLU, no
# LayerNorm, a plain embedding and head. And moe_ffn at Switch-Base-8's
# widths (Fedus, Zoph and Shazeer, arXiv:2101.03961).
# ---------------------------------------------------------------------------

WT = dict(layers=16, dim=1024, heads=8, train_len=512, cache_len=1024,
          vocab=267735)
WT_SLOTS, WT_BUCKETS = 32, "32,128,512"
WT_SEQS, WT_NEW, WT_PLEN = 64, 64, (16, 512)
WT_CHECK_TOKENS = 8
WT_TRAIN_BATCH, WT_TRAIN_STEPS = 8, 10
WT_CHECK_LAYERS, WT_CHECK_T, WT_CHECK_BATCH, WT_TOL = 2, 32, 2, 1e-4
WT_PROFILE_STEPS = 20
SWITCH = dict(dim=768, ff=3072, experts=8, top=1, cf=1.25, tokens=4096)
SWITCH_TOL = 1e-4


@contextlib.contextmanager
def matmul_tf32(on):
    """TF32 in matmuls and cuDNN, on or off, restored after."""
    import torch
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = old


@contextlib.contextmanager
def env_set(**values):
    """Environment variables set for the block, restored after."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def wt_weights(mt, sym, seed, layers, device):
    """Weights for build_lm at WT's widths, drawn on ``device`` from
    ``seed``: N(0, 1/fan_in) in every projection (the two that feed the
    residual stream also over 2 x layers, so 16 layers keep its scale),
    N(0, 1) embeddings, zero biases. {name: NDArray on device}."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = dict(zip(sym.list_arguments(), sym.infer_shape(
        data=(1, 8), pos=(1,), **{"%sc%d" % (c, i): (1, 8, WT["dim"])
                                  for c in "kv" for i in range(layers)})[0]))
    out = {}
    for name, shape in sorted(shapes.items()):
        if not name.endswith(("_weight", "_bias")):
            continue
        if name.endswith("_bias"):
            t = torch.zeros(shape, device=device)
        else:
            std = 1.0 if name == "tok_emb_weight" else shape[1] ** -0.5
            if name.endswith(("_o_weight", "_f2_weight")):
                std /= (2 * layers) ** 0.5
            t = torch.randn(shape, generator=gen, device=device) * std
        out[name] = mt.nd.NDArray(t, mt.gpu(0) if t.is_cuda else mt.cpu())
    return out


def wt_prompts(seed):
    """WT_SEQS prompts, lengths uniform in WT_PLEN, tokens uniform over the
    vocabulary, from ``seed``."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(WT_PLEN[0], WT_PLEN[1] + 1, size=WT_SEQS)
    return [rng.randint(0, WT["vocab"], size=n).astype(np.int32)
            for n in lens]


def wt_decode_bound(engine, slots):
    """Bytes a decode step must move (every weight but the embedding read
    once, K embedding rows, the whole K-slot cache read once and K rows a
    cache written, the tokens) and its FLOPs (2 a weight a slot, and the
    K rows' attention over the cache): (bytes, FLOPs)."""
    params = dict(zip(engine._param_names, engine._stores[0][0]))
    S, D, L = WT["cache_len"], WT["dim"], WT["layers"]
    dense = sum(v.numel() for n, v in params.items() if n != "tok_emb_weight")
    nbytes = 4 * (dense + slots * D + 2 * L * slots * S * D
                  + 2 * L * slots * D + 2 * slots)
    flops = 2 * slots * dense + 2 * 2 * L * slots * S * D
    return nbytes, flops


def wt_checked(prompts):
    """The indices of the shortest prompt in each prefill bucket of
    WT_BUCKETS that any prompt falls in, so the check against the CPU
    runs every prefill graph, and decodes at positions up to the 512
    bucket's."""
    buckets = [int(b) for b in WT_BUCKETS.split(",")]
    short = {}
    for i, p in enumerate(prompts):
        b = min(b for b in buckets if len(p) <= b)
        if b not in short or len(p) < len(prompts[short[b]]):
            short[b] = i
    return [short[b] for b in sorted(short)]


def wt_serve(mt, seed, card):
    """The full-width GEN engine on gpu(0): WT_SEQS prompts through
    GenerateScheduler (K = WT_SLOTS, prefill buckets WT_BUCKETS), timed;
    then the shortest prompt of each bucket on the CPU from the same
    weights: the first WT_CHECK_TOKENS tokens must agree. TF32 off.
    Returns a dict of numbers."""
    import gc
    import torch
    from mxtpu_torch.serving import GenerateScheduler, InferenceEngine
    gpu = mt.gpu(0)
    L = WT["layers"]
    gen_sym = char_lm_gen_symbol(mt, WT["dim"], WT["heads"], L,
                                 WT["cache_len"], vocab=WT["vocab"])
    weights = wt_weights(mt, gen_sym, seed, L, torch.device("cuda", 0))
    n_param = sum(v.size for v in weights.values())
    prompts = wt_prompts(seed)
    checked = wt_checked(prompts)
    out = {"params": n_param}
    clock = [("start", time.perf_counter())]
    with env_set(MXTPU_SERVE_GENERATE_SLOTS=WT_SLOTS,
                 MXTPU_SERVE_GENERATE_PREFILL_BUCKETS=WT_BUCKETS):
        t0 = time.perf_counter()
        engine = InferenceEngine(gen_sym, weights, {}, {"data": (1,)},
                                 buckets=(1,), ctx=gpu)
        torch.cuda.synchronize()
        out["warm_s"] = time.perf_counter() - t0
        before = engine.cache.compiles
        sched = GenerateScheduler(engine, 2 * WT_SEQS)
        t0 = time.perf_counter()
        reqs = [sched.submit("w%d" % i, p, WT_NEW)
                for i, p in enumerate(prompts)]
        replies = [r.wait(600) for r in reqs]
        wall = time.perf_counter() - t0
        bad = [r for r in replies if r[0] != "ok"]
        if bad:
            fail("full-width serving: %d sequences failed: %s"
                 % (len(bad), bad[:2]))
        tokens = [r[1]["tokens"].tolist() for r in replies]
        steps = np.array(sched.step_times())
        ttft = np.array([r.ttft_ms for r in reqs])
        stats = sched.stats()
        sched.drain()
        out.update(
            tokens=sum(len(t) for t in tokens), wall_s=wall,
            ttft_p50=float(np.percentile(ttft, 50)),
            ttft_p99=float(np.percentile(ttft, 99)),
            step_p50=float(np.percentile(steps, 50)),
            step_p99=float(np.percentile(steps, 99)), steps=len(steps),
            compiles=(before, engine.cache.compiles), sched=stats,
            mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        if engine.cache.compiles != before:
            fail("full-width serving built programs while answering (%d -> "
                 "%d)" % (before, engine.cache.compiles))
        if any(len(t) != WT_NEW for t in tokens):
            fail("full-width serving: a sequence stopped short of %d "
                 "tokens" % WT_NEW)
        nbytes, flops = wt_decode_bound(engine, WT_SLOTS)
        out["bound_ms"] = max(nbytes / PEAK_BYTES_S, flops / PEAK_F32) * 1e3
        out["bound_by"] = "bytes" if nbytes / PEAK_BYTES_S >= \
            flops / PEAK_F32 else "operations"
        out["bound_bytes"], out["bound_flops"] = nbytes, flops
        # the decode step alone: its card time and busy share, on the
        # drained lane's state (its captured program)
        params, aux, _v = engine._resolve_store(None)
        state = engine.gen_state_init(WT_SLOTS)

        def step():
            engine.gen_step(state, params, aux)[0].cpu()
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WT_PROFILE_STEPS):
            step()
        out["step_wall"] = (time.perf_counter() - t0) / WT_PROFILE_STEPS \
            * 1e3
        out["busy"], out["top"] = device_time(step, WT_PROFILE_STEPS)
        if engine.cache.compiles != before:
            fail("the decode step's timing built a program")
        out["graphs"] = gen_graphs(engine)
        engine.gen_state_release(state)
        clock.append(("card", time.perf_counter()))
        host = {k: v.asnumpy() for k, v in weights.items()}
        del engine, sched, weights, params, aux, state
        gc.collect()
        torch.cuda.empty_cache()
    # the CPU from the same weights, a slot a checked prompt, float32
    with env_set(MXTPU_SERVE_GENERATE_SLOTS=len(checked),
                 MXTPU_SERVE_GENERATE_PREFILL_BUCKETS=WT_BUCKETS), \
            mt.cpu():
        t0 = time.perf_counter()
        cpu_engine = InferenceEngine(gen_sym, host, {}, {"data": (1,)},
                                     buckets=(1,), ctx=mt.cpu())
        sched = GenerateScheduler(cpu_engine, 8)
        reqs = [sched.submit("c%d" % i, prompts[i], WT_CHECK_TOKENS)
                for i in checked]
        replies = [r.wait(600) for r in reqs]
        sched.drain()
        if any(r[0] != "ok" for r in replies):
            fail("full-width serving on the CPU: %s" % (replies,))
        want = [r[1]["tokens"].tolist() for r in replies]
        out["cpu_s"] = time.perf_counter() - t0
    clock.append(("cpu", time.perf_counter()))
    for i, w in zip(checked, want):
        if tokens[i][:WT_CHECK_TOKENS] != w:
            fail("full-width serving: sequence %d's first %d tokens on "
                 "gpu(0) %s, on the CPU %s" % (i, WT_CHECK_TOKENS,
                                               tokens[i][:WT_CHECK_TOKENS],
                                               w))
    out["checked"] = [len(prompts[i]) for i in checked]
    del cpu_engine, host
    gc.collect()
    out["clock"] = ", ".join("%s %.1f" % (name, t - clock[i][1])
                             for i, (name, t) in enumerate(clock[1:]))
    return out


def wt_train_flops(batch, T):
    """FLOPs of one training step of WT's TRAIN symbol at ``batch`` x T: 6
    a weight a token (forward, and the two products of the backward) but
    the embedding's lookup, and the dense causal attention's four
    products (T x T scores, all computed) three times over."""
    L, D, V = WT["layers"], WT["dim"], WT["vocab"]
    dense = L * (4 * D * D + 4 * D * D) + D * V
    tokens = batch * T
    return 6 * tokens * dense + 3 * 2 * 2 * L * batch * T * T * D


def wt_check_grads(mt, seed):
    """The first forward/backward of the TRAIN symbol at WT's widths with
    WT_CHECK_LAYERS layers and T = WT_CHECK_T on gpu(0) against the CPU
    (TF32 off): the softmax and every weight's gradient within WT_TOL of
    its largest value. Returns (worst, arrays compared)."""
    import torch
    T, L, B = WT_CHECK_T, WT_CHECK_LAYERS, WT_CHECK_BATCH
    sym = char_lm_train_symbol(mt, WT["dim"], WT["heads"], L, T,
                               vocab=WT["vocab"])
    args = {k: v.asnumpy() for k, v in wt_weights(
        mt, sym, seed, L, torch.device("cuda", 0)).items()}
    rng = np.random.RandomState(seed)
    x = rng.randint(0, WT["vocab"], size=(B, T)).astype("f")
    y = rng.randint(0, WT["vocab"], size=(B * T,)).astype("f")
    feed = {"data": x, "pos": np.zeros((B,), "f"), "softmax_label": y}
    for i in range(L):
        feed["kc%d" % i] = feed["vc%d" % i] = np.zeros((B, T, WT["dim"]),
                                                       "f")
    got = {}
    for label, ctx in (("gpu", mt.gpu(0)), ("cpu", mt.cpu())):
        with ctx:
            ex = sym.simple_bind(ctx, grad_req="write",
                                 **{k: v.shape for k, v in feed.items()})
            for k, v in ex.arg_dict.items():
                v[:] = feed[k] if k in feed else args[k]
            out = ex.forward(is_train=True)[0].asnumpy()
            ex.backward()
            got[label] = dict({k: g.asnumpy() for k, g in
                               ex.grad_dict.items()
                               if g is not None and k in args},
                              softmax=out)
            del ex
    worst = 0.0
    top = max(float(np.abs(g).max()) for k, g in got["cpu"].items()
              if k != "softmax")
    for k, want in got["cpu"].items():
        if k.endswith(A7_NO_GRAD):
            # rounding alone on either device: small beside every other
            # gradient, not close to each other
            noise = max(float(np.abs(got[d][k]).max()) for d in got)
            if not noise <= WT_TOL * top:
                fail("full-width LM: %s's gradient %.3g, not rounding "
                     "beside the largest gradient %.3g" % (k, noise, top))
            continue
        err = float(np.abs(got["gpu"][k] - want).max()) / max(
            float(np.abs(want).max()), 1e-30)
        worst = max(worst, err)
        if not err <= WT_TOL:
            fail("full-width LM (%d layers, T=%d): %s on gpu(0) differs "
                 "from the CPU by %.3g of its largest value (limit %g)"
                 % (L, T, k, err, WT_TOL))
    return worst, len(got["cpu"])


def fused_summary(mod, steps, label):
    """Fail unless all ``steps`` steps of ``mod``'s fit ran fused with no
    fallback, each signature's graph replayed at every step after its
    first two. Returns (text, the entries holding a graph)."""
    trainer = mod._fused
    if trainer is None:
        fail("%s: the fused step is not engaged (%s)"
             % (label, getattr(mod, "_fused_fallback_logged", "disabled")))
    stats = trainer._group.stats
    entries = trainer._cache.entries()
    graphs = [e for e in entries if e.graph is not None]
    replays = sum(e.replays for e in entries)
    if stats["steps"] != steps or stats["fallbacks"] or not graphs or \
            replays != steps - stats["compiles"]:
        fail("%s: fused stats %s, %d replays of %d graphs in %d signatures"
             % (label, stats, replays, len(graphs), len(entries)))
    return ("%d steps: %d compiles, %d captures, %d replays, pool %s MB"
            % (steps, stats["compiles"], len(graphs), replays, ", ".join(
                "%.1f" % (e.pool_bytes / 2 ** 20) for e in graphs)), graphs)


def wt_train(mt, seed, card):
    """WT_TRAIN_STEPS captured Module.fit steps of the TRAIN symbol at
    WT_TRAIN_BATCH x train_len with Adam on gpu(0), TF32 on: ms a step of
    the fit (each batch fed from the host: the tokens and the zero caches
    the TRAIN symbol takes as data) and of the captured step alone (CUDA
    events over replays of its graph), against the FLOPs bound; the peak
    memory. Returns a dict of numbers."""
    import gc
    import torch
    T, L, B = WT["train_len"], WT["layers"], WT_TRAIN_BATCH
    sym = char_lm_train_symbol(mt, WT["dim"], WT["heads"], L, T,
                               vocab=WT["vocab"])
    gpu = mt.gpu(0)
    rng = np.random.RandomState(seed)
    n, epochs = B * WT_TRAIN_STEPS, 1
    ids = rng.randint(0, WT["vocab"], size=(n, T + 1)).astype("f")
    zeros = np.zeros((n, T, WT["dim"]), "f")
    feed = {"data": ids[:, :T], "pos": np.zeros((n,), "f")}
    for i in range(L):
        feed["kc%d" % i] = feed["vc%d" % i] = zeros
    batch_bytes = sum(v[:B].nbytes for v in feed.values()) + 4 * B * T
    it = mt.io.NDArrayIter(feed, {"softmax_label": ids[:, 1:]},
                           batch_size=B)
    torch.cuda.reset_peak_memory_stats()
    with gpu, matmul_tf32(True):
        weights = wt_weights(mt, sym, seed, L, torch.device("cuda", 0))
        mod = mt.mod.Module(sym, context=gpu, data_names=sorted(feed),
                            label_names=["softmax_label"])
        times = []

        def clock(_param):
            torch.cuda.synchronize()
            times.append(time.perf_counter())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.fit(it, num_epoch=epochs, optimizer="adam",
                optimizer_params={"learning_rate": 1e-4},
                arg_params=weights, batch_end_callback=clock,
                eval_metric=mt.metric.Perplexity(ignore_label=None))
        fit_s = time.perf_counter() - t0
        text, graphs = fused_summary(mod, WT_TRAIN_STEPS, "full-width LM")
        held = cuda_ms(graphs[-1].replay, iters=3, warmup=1)
    fed = np.diff(times)[2:] * 1e3      # steps 4.. replay the graph
    window = times[-1] - times[2]
    flops = wt_train_flops(B, T)
    out = {"step_ms": float(np.median(fed)), "held_ms": held,
           "window_s": window, "tok_s": len(fed) * B * T / window,
           "fit_s": fit_s, "steps": fed.tolist(), "flops": flops,
           "batch_mb": batch_bytes / 1e6,
           "bound_ms": flops / PEAK_TF32 * 1e3, "capture": text,
           "mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del mod, weights, it, graphs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def switch_relu_mask(xs, sw):
    """The dispatch tensor and the experts' ReLU branch (pre-activation >
    0, ``(E, C, F)``) of moe_ffn on ``xs``, as its forward computes them."""
    import torch
    from mxtpu_torch.parallel.moe import moe_capacity, moe_dispatch
    x, gate, w1, b1 = (t.detach() for t in xs[:4])
    with torch.no_grad():
        disp = moe_dispatch(x @ gate, moe_capacity(
            x.shape[0], gate.shape[1], sw["cf"], sw["top"]), sw["top"])[0]
        h = torch.einsum("ecd,edh->ech", torch.einsum(
            "tec,td->ecd", disp, x), w1) + b1[:, None, :]
    return disp.cpu().numpy(), (h > 0).cpu().numpy()


def switch_moe_check(mt, seed, card_dev=None):
    """moe_ffn at Switch-Base-8's widths (d_model 768, d_ff 3,072, 8
    experts, top-1, capacity factor 1.25) on 4,096 tokens, f32, TF32 off:
    forward and backward on gpu(0) against the CPU. The routing must be
    the same (equal dispatch tensors); the output, aux and every gradient
    within SWITCH_TOL of its largest value, except where the two devices
    took different ReLU branches (a pre-activation within rounding of 0:
    float32 against float64 moves w1's gradient by 5% of its largest on
    the CPU alone), whose w1 columns, b1 entries and token rows are
    counted and left out. Then the card's forward and forward + backward
    ms (CUDA events) against the bound of the einsum formulation. Returns
    a dict of numbers."""
    import torch
    from mxtpu_torch.parallel.moe import moe_capacity
    from mxtpu_torch.ops.nn import moe_ffn
    sw = SWITCH
    D, F, E, N = sw["dim"], sw["ff"], sw["experts"], sw["tokens"]
    rng = np.random.RandomState(seed)
    host = [rng.randn(N, D).astype("f"),
            (rng.randn(D, E) * D ** -0.5).astype("f"),
            (rng.randn(E, D, F) * D ** -0.5).astype("f"),
            np.zeros((E, F), "f"),
            (rng.randn(E, F, D) * F ** -0.5).astype("f"),
            np.zeros((E, D), "f")]
    cot = rng.randn(N, D).astype("f")
    card_dev = card_dev or torch.device("cuda", 0)
    got, masks = {}, {}
    for label, dev in (("gpu", card_dev), ("cpu", torch.device("cpu"))):
        xs = [torch.tensor(a, device=dev, requires_grad=True) for a in host]
        y, aux = moe_ffn(*xs, capacity_factor=sw["cf"],
                         num_selected=sw["top"])
        (y * torch.tensor(cot, device=dev)).sum().add(aux.sum()).backward()
        masks[label] = switch_relu_mask(xs, sw)
        got[label] = [y.detach().cpu().numpy(), aux.detach().cpu().numpy()
                      ] + [x.grad.cpu().numpy() for x in xs]
    disp = masks["cpu"][0]
    if not np.array_equal(masks["gpu"][0], disp):
        fail("moe_ffn at Switch-Base-8: the routing on gpu(0) differs from "
             "the CPU's")
    flips = masks["gpu"][1] != masks["cpu"][1]            # (E, C, F)
    keep = [None, None,
            ~(disp[:, flips.any(-1)].any(-1))[:, None],      # x's rows
            None, ~flips.any(1)[:, None, :],                 # w1 (E, D, F)
            ~flips.any(1), None, None]                       # b1 (E, F)
    worst = 0.0
    names = ("y", "aux", "x", "gate_weight", "w1", "b1", "w2", "b2")
    for name, g, w, k in zip(names, got["gpu"], got["cpu"], keep):
        scale = max(float(np.abs(w).max()), 1e-30)
        diff = np.abs(g - w)
        if k is not None:
            diff = np.where(k, diff, 0.0)
        err = float(diff.max()) / scale
        worst = max(worst, err)
        if not err <= SWITCH_TOL:
            fail("moe_ffn at Switch-Base-8: %s on gpu(0) differs from the "
                 "CPU by %.3g of its largest value (limit %g; %d ReLU "
                 "branches differ)" % (name, err, SWITCH_TOL,
                                       int(flips.sum())))
    xs = [torch.tensor(a, device=card_dev, requires_grad=True)
          for a in host]
    g_y = torch.tensor(cot, device=card_dev)

    def fwd():
        with torch.no_grad():
            moe_ffn(*xs, capacity_factor=sw["cf"], num_selected=sw["top"])

    def fwd_bwd():
        y, aux = moe_ffn(*xs, capacity_factor=sw["cf"],
                         num_selected=sw["top"])
        torch.autograd.backward([y, aux], [g_y, torch.ones_like(aux)])
    C = moe_capacity(N, E, sw["cf"], sw["top"])
    # dispatch and combine: 2 products of T x (E C) x D; the experts: 2 of
    # E C x D x F; the gate: T x D x E
    flops = 2 * (2 * N * E * C * D + 2 * E * C * D * F + N * D * E)
    nbytes = 4 * (N * D * 2 + D * E + 2 * E * D * F + E * F + E * D)
    return {"worst": worst, "capacity": C, "flops": flops,
            "flips": int(flips.sum()), "units": int(flips.size),
            "fwd_ms": cuda_ms(fwd, iters=20),
            "fwd_bwd_ms": cuda_ms(fwd_bwd, iters=10),
            "bound_ms": max(flops / PEAK_F32, nbytes / PEAK_BYTES_S) * 1e3,
            "kept": int(disp.sum())}


def wt_phase(mt, seed, card):
    """Phase 25: the full-width ALiBi LM served (WT_SEQS sequences through
    GenerateScheduler, its first tokens against the CPU) and trained (the
    first forward/backward at 2 layers against the CPU, then
    WT_TRAIN_STEPS captured steps), and moe_ffn at Switch-Base-8's widths
    against the CPU. Prints each result beside its bound and the phase's
    seconds by part."""
    import torch
    clock = [("start", time.perf_counter())]
    with matmul_tf32(False):
        sv = wt_serve(mt, seed, card)
    clock.append(("serve", time.perf_counter()))
    tok_s = sv["tokens"] / sv["wall_s"]
    print("full-width ALiBi LM (%d layers, d %d, %d heads, vocabulary %d, "
          "cache %d; %d weights, f32, TF32 off) served on gpu(0) by "
          "GenerateScheduler: %d sequences (prompts %d-%d tokens, %d new "
          "each, K = %d slots, prefill buckets %s) in %.3f s: %.1f tokens/s; "
          "TTFT p50 %.3f ms, p99 %.3f ms; decode step (program call + the "
          "read of its K tokens) p50 %.4f ms, p99 %.4f ms over %d steps, "
          "bound %.4f ms (%.4g bytes at 3.35 TB/s, %.4g FLOPs; %s), p50 at "
          "%.1f%% of it; the step alone %.4f ms, %s; %s; captures %d before "
          "the sequences, %d after (%d generation programs, each a CUDA "
          "graph); engine warm-up %.1f s; peak memory %.2f GB | %s"
          % (WT["layers"], WT["dim"], WT["heads"], WT["vocab"],
             WT["cache_len"], sv["params"], WT_SEQS, WT_PLEN[0], WT_PLEN[1],
             WT_NEW, WT_SLOTS, WT_BUCKETS, sv["wall_s"], tok_s,
             sv["ttft_p50"], sv["ttft_p99"], sv["step_p50"], sv["step_p99"],
             sv["steps"], sv["bound_ms"], sv["bound_bytes"],
             sv["bound_flops"], sv["bound_by"],
             100 * sv["bound_ms"] / sv["step_p50"], sv["step_wall"],
             busy_of(sv["busy"], sv["step_wall"]), sv["top"],
             sv["compiles"][0], sv["compiles"][1], sv["graphs"],
             sv["warm_s"], sv["mem_gb"], card), flush=True)
    print("full-width ALiBi LM: the first %d tokens of the shortest "
          "sequence in each prefill bucket (prompts of %s tokens, buckets "
          "%s) on gpu(0) equal the CPU's from the same weights (%.1f s on "
          "the CPU; serving %s s)"
          % (WT_CHECK_TOKENS, sv["checked"], WT_BUCKETS, sv["cpu_s"],
             sv["clock"]), flush=True)
    with matmul_tf32(False):
        worst, n = wt_check_grads(mt, seed)
    clock.append(("gradient check", time.perf_counter()))
    print("full-width ALiBi LM at %d layers, T = %d, batch %d (TF32 off): "
          "the first forward/backward on gpu(0) against the CPU: softmax "
          "and %d gradients within %.3g of their largest values (limit %g), "
          "the %d key biases' (rounding alone) below %g of the largest "
          "gradient" % (WT_CHECK_LAYERS, WT_CHECK_T, WT_CHECK_BATCH,
                        n - 1 - WT_CHECK_LAYERS, worst, WT_TOL,
                        WT_CHECK_LAYERS, WT_TOL), flush=True)
    tr = wt_train(mt, seed, card)
    clock.append(("train", time.perf_counter()))
    print("full-width ALiBi LM trained through Module.fit on gpu(0) (Adam, "
          "batch %d x %d, TF32 on): %s; steps 4-%d fed from the host: "
          "%.1f tokens/s over the whole window (%.3f s, %.3f ms a step), "
          "the median step %.3f ms (steps: %s; each batch %.1f MB from the "
          "host, the zero caches most of it); the captured step alone "
          "%.3f ms; bound %.3f ms (%.4g FLOPs at TF32's 495 TFLOP/s; "
          "operations), %.1f%% of it; fit %.1f s; peak memory %.2f GB | %s"
          % (WT_TRAIN_BATCH, WT["train_len"], tr["capture"], WT_TRAIN_STEPS,
             tr["tok_s"], tr["window_s"],
             tr["window_s"] * 1e3 / len(tr["steps"]), tr["step_ms"],
             ", ".join("%.3f" % v for v in tr["steps"]), tr["batch_mb"],
             tr["held_ms"], tr["bound_ms"], tr["flops"],
             100 * tr["bound_ms"] / tr["held_ms"], tr["fit_s"],
             tr["mem_gb"], card), flush=True)
    with matmul_tf32(False):
        sw = switch_moe_check(mt, seed)
    clock.append(("moe", time.perf_counter()))
    print("moe_ffn at Switch-Base-8 (d_model %d, d_ff %d, %d experts, top-%d, "
          "capacity factor %g: %d slots an expert, %d of %d tokens kept), "
          "f32, TF32 off: routing on gpu(0) equal to the CPU's, values and "
          "gradients within %.3g of their largest (limit %g) where both "
          "took the same ReLU branch (%d of %d differ); forward %.4f "
          "ms, forward + backward %.4f ms; the forward's bound %.4f ms "
          "(%.4g FLOPs of the einsum formulation at float32's 67 TFLOP/s; "
          "operations), %.1f%% of it | %s"
          % (SWITCH["dim"], SWITCH["ff"], SWITCH["experts"], SWITCH["top"],
             SWITCH["cf"], sw["capacity"], sw["kept"], SWITCH["tokens"],
             sw["worst"], SWITCH_TOL, sw["flips"], sw["units"],
             sw["fwd_ms"], sw["fwd_bwd_ms"],
             sw["bound_ms"], sw["flops"],
             100 * sw["bound_ms"] / sw["fwd_ms"], card), flush=True)
    torch.cuda.empty_cache()
    print("full-width phase: %.1f s (%s)" % (
        clock[-1][1] - clock[0][1], ", ".join(
            "%s %.1f" % (name, t - clock[i][1])
            for i, (name, t) in enumerate(clock[1:]))), flush=True)



# ---------------------------------------------------------------------------
# The rest of Module and the optimizer library (ROADMAP A18 and A4): fit.py's
# --optimizer / --initializer / --top-k / --loss at ResNet-50's width, every
# optimizer of the registry through LeNet's Module.fit, eager and captured,
# RNN checkpoints on the bucketed LSTM LM, and the examples SequentialModule,
# PythonLossModule and Monitor open
# ---------------------------------------------------------------------------

# (a) fit.py's flags: train_imagenet.py --benchmark 1 --optimizer nag --mom
# 0.9 --wd 1e-4 --initializer msra --top-k 5 --loss ce,nll
FF_FLAGS = dict(optimizer="nag", initializer="msra", top_k=5, loss="ce,nll")
FF_CHECK_STEPS = 3          # captured vs eager from the same weights
FF_TIMED_STEPS = 10
# MSRAPrelu draws N(0, s^2), s = sqrt(2 / (1 + 0.25^2) / ((fan_in +
# fan_out) / 2)): over a weight of n entries the sample mean has a
# standard error of s / sqrt(n) and the sample deviation one of s /
# sqrt(2 n) (1.6% and 1.1% of s over ResNet-50's smallest, 4,096); each is
# held within FF_SCALE_SE of its standard errors
FF_SCALE_SE = 5.0
# the host recompute of top-5 / CE / NLL: counts exact, float32 sums of
# logs in another order within 1e-5 relative
FF_METRIC_RTOL = 1e-5


def msra_scale_check(args, slope=0.25):
    """Fail unless every weight of {name: numpy} drawn by MSRAPrelu has
    the deviation its formula gives and mean 0, each within FF_SCALE_SE
    standard errors. Returns (weights checked, the worst reading in
    standard errors)."""
    magnitude = 2.0 / (1 + slope ** 2)
    worst, n = 0.0, 0
    for name, w in sorted(args.items()):
        if not name.endswith("_weight") or w.ndim < 2:
            continue
        hw = float(np.prod(w.shape[2:])) if w.ndim > 2 else 1.0
        factor = (w.shape[1] * hw + w.shape[0] * hw) / 2.0
        scale = (magnitude / factor) ** 0.5
        off = max(abs(float(w.std()) / scale - 1.0) * (2 * w.size) ** 0.5,
                  abs(float(w.mean())) / scale * w.size ** 0.5)
        if off > FF_SCALE_SE:
            fail("MSRAPrelu: %s %s has deviation %.4g and mean %.3g, the "
                 "formula's deviation %.4g (%.1f standard errors off, limit "
                 "%g)" % (name, w.shape, w.std(), w.mean(), scale, off,
                          FF_SCALE_SE))
        worst, n = max(worst, off), n + 1
    return n, worst


def metric_recompute(probs, labels, top_k=5, eps=1e-12):
    """fit.py's metrics over host arrays, as mxtpu's host updates compute
    them: (hits, top-k hits, the sum of -log(p + eps), which CE and NLL
    both average, rows)."""
    hits = topk = 0
    ce = 0.0
    rows = 0
    for p, y in zip(probs, labels):
        y = y.astype(np.int64)
        hits += int((p.argmax(1) == y).sum())
        ranked = np.argsort(p.astype(np.float32), axis=-1)
        topk += int((ranked[:, -top_k:] == y[:, None]).any(1).sum())
        ce += float(-np.log(p[np.arange(len(y)), y] + eps).sum())
        rows += len(y)
    return hits, topk, ce, rows


def fit_flags_phase(mt, seed, card, sgd_ms):
    """(a) train_imagenet.py --benchmark 1 with fit.py's --optimizer nag
    --initializer msra --top-k 5 --loss ce,nll at ResNet-50's width (224,
    batch 128), TF32 off: MSRAPrelu's scale, FF_CHECK_STEPS captured steps
    against eager ones from the same weights (deterministic cuDNN), the
    captured step timed with update_metric's host ms (the composite metric
    stays on the host), beside ``sgd_ms`` (phase 14's captured SGD step in
    this run), and top-5 / CE / NLL against a host recompute of the same
    outputs. Returns (ms a step, the MSRAPrelu weights ({name: numpy}
    args, aux) it drew)."""
    import gc
    import torch
    gpu = mt.gpu(0)
    t_phase = time.time()

    def resnet50(pkg):
        return resnet_symbol(pkg, 50, RN_SHAPE, RN_CLASSES)

    def run(kv, steps, args=None, aux=None, callbacks=None):
        np.random.seed(seed)
        mt.random.seed(seed)
        return imagenet_fit(mt, resnet50(mt), RN_BATCH, steps * RN_BATCH, 1,
                            RN_SHAPE, RN_CLASSES, context=gpu, kvstore=kv,
                            arg_params=args, aux_params=aux,
                            batch_end_callback=callbacks, **FF_FLAGS)

    # the weights fit's initializer draws (fit.py's table: MSRAPrelu)
    mt.random.seed(seed)
    dims = tuple(int(x) for x in RN_SHAPE.split(","))
    init_mod = mt.mod.Module(resnet50(mt), context=mt.cpu())
    init_mod.bind([("data", (RN_CHECK_BATCH,) + dims)],
                  [("softmax_label", (RN_CHECK_BATCH,))])
    init_mod.init_params(fit_initializer(mt, FF_FLAGS["initializer"]))
    args0 = module_params(init_mod)
    aux0 = module_aux(init_mod)
    del init_mod
    n_w, off = msra_scale_check(args0)
    print("fit.py --initializer msra: %d weights drawn by %s with their "
          "formula's deviation and mean 0 (worst %.2f standard errors off, "
          "limit %g)" % (n_w, type(fit_initializer(mt, "msra")).__name__,
                         off, FF_SCALE_SE), flush=True)

    # captured against eager, deterministic cuDNN, from the same weights
    got = {}
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for kv in (None, "local"):
            mod, _ = run(kv, FF_CHECK_STEPS, args0, aux0)
            if type(mod._optimizer).__name__ != "NAG":
                fail("fit.py --optimizer nag made %s"
                     % type(mod._optimizer).__name__)
            if kv == "local":
                text = capture_report(mod, FF_CHECK_STEPS,
                                      "ResNet-50 NAG capture check")[0]
            got[kv] = (module_params(mod), module_aux(mod))
            del mod
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = old
    for i, what in enumerate(("weights", "moving statistics")):
        names = sorted(got[None][i])
        check_close("ResNet-50 NAG: %d captured steps vs eager ones (batch "
                    "%d, deterministic cuDNN), %s" % (FF_CHECK_STEPS,
                                                      RN_BATCH, what),
                    [torch.from_numpy(got["local"][i][k]) for k in names],
                    [torch.from_numpy(got[None][i][k]) for k in names],
                    CAPTURE_TOL)
    print("ResNet-50 NAG + MSRAPrelu at batch %d, captured vs eager: %s; "
          "max |diff| weights %.3g, moving statistics %.3g (tolerance %s)"
          % (RN_BATCH, text,
             max(float(np.abs(got["local"][0][k] - got[None][0][k]).max())
                 for k in got[None][0]),
             max(float(np.abs(got["local"][1][k] - got[None][1][k]).max())
                 for k in got[None][1]), CAPTURE_TOL), flush=True)
    del got
    gc.collect()

    # the captured step timed, fit.py's metric list on the host
    mod, it = run("local", 1)
    metric = mt.metric.create(fit_metrics(mt, FF_FLAGS["top_k"],
                                          FF_FLAGS["loss"]))
    it.max_iter = FF_TIMED_STEPS
    clock = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = fit_epoch(mod, it, metric, clock)
    torch.cuda.synchronize()
    step = (time.perf_counter() - t0) / steps * 1e3
    capture_report(mod, 1 + steps, "ResNet-50 NAG")
    host = "; ".join("%s %.3f" % (p, v / steps * 1e3)
                     for p, v in clock.items())
    # the metrics against a host recompute of the same steps' outputs
    metric.reset()
    it.reset()
    probs, labels = [], []
    batch = None
    for _ in range(FF_CHECK_STEPS):
        batch, _n = fit_steps(mod, it, metric, steps=1, batch=batch)
        probs.append(mod.get_outputs()[0].asnumpy())
        labels.append(it._label.asnumpy())
    hits, topk, ce, rows = metric_recompute(probs, labels,
                                            FF_FLAGS["top_k"])
    got = dict(metric.get_name_value())
    want = {"accuracy": hits / rows, "top_k_accuracy_5": topk / rows,
            "cross-entropy": ce / rows, "nll-loss": ce / rows}
    if sorted(got) != sorted(want):
        fail("fit.py's metrics are %s, want %s" % (sorted(got),
                                                   sorted(want)))
    for k, w in want.items():
        exact = k in ("accuracy", "top_k_accuracy_5")
        if (got[k] != w) if exact else \
                not abs(got[k] - w) <= FF_METRIC_RTOL * abs(w):
            fail("ResNet-50 NAG: %s %.8g, the host recompute %.8g" % (
                k, got[k], w))
    print("ResNet-50 --optimizer nag --initializer msra --top-k 5 --loss "
          "ce,nll (captured, TF32 off): %.3f ms a step over %d steps (%.1f "
          "images/s) beside the SGD step's %s ms in this run; host ms a "
          "step by phase: %s; metrics over %d steps %s equal a host "
          "recompute (counts exactly, CE/NLL within %g); phase %.1f s | %s"
          % (step, steps, RN_BATCH / step * 1e3,
             "%.3f" % sgd_ms if sgd_ms is not None else "not measured",
             host, FF_CHECK_STEPS, ", ".join(
                 "%s %.6f" % kv for kv in sorted(got.items())),
             FF_METRIC_RTOL, time.time() - t_phase, card), flush=True)
    del mod, it
    gc.collect()
    torch.cuda.empty_cache()
    return step, (args0, aux0)


# (b) every optimizer mxtpu registers through LeNet's Module.fit (BASELINE
# config 1), with the momentum, weight decay and clipping each takes (the
# Module sets rescale_grad to 1 / batch): OPT_STEPS eager and OPT_STEPS
# captured steps from the same weights and batches. A captured fit runs
# its first two steps for real (the bare step, then the step with the
# metric), captures at the third and replays after, so every t-dependent
# factor moves over 5 replays past the capture.
OPT_STEPS = 8
_MOM = dict(momentum=0.9, wd=1e-4, clip_gradient=5.0)
_DECAY = dict(wd=1e-4, clip_gradient=5.0)
OPT_SWEEP = {
    "sgd": dict(learning_rate=0.05, **_MOM),
    "ccsgd": dict(learning_rate=0.05, **_MOM),
    "nag": dict(learning_rate=0.05, **_MOM),
    "dcasgd": dict(learning_rate=0.05, **_MOM),
    # the warmup multiplier moves every step (t / 8 of the way to 2)
    "lbsgd": dict(learning_rate=0.05, warmup_strategy="linear",
                  warmup_epochs=1, updates_per_epoch=OPT_STEPS,
                  batch_scale=2, **_MOM),
    "signum": dict(learning_rate=1e-3, wd_lh=1e-4, **_MOM),
    "ftml": dict(learning_rate=1e-3, **_DECAY),
    "sgld": dict(learning_rate=1e-4, **_DECAY),
    "adam": dict(learning_rate=1e-3, **_DECAY),
    "adagrad": dict(learning_rate=0.01, **_DECAY),
    "rmsprop": dict(learning_rate=1e-3, centered=True, **_DECAY),
    "adadelta": dict(**_DECAY),
    "ftrl": dict(learning_rate=0.1, **_DECAY),
    "adamax": dict(learning_rate=2e-3, **_DECAY),
    "nadam": dict(learning_rate=1e-3, **_DECAY),
    "test": {},
}
# Captured against eager (deterministic cuDNN, f32): the same kernels on
# the same inputs, only lr a float32 device scalar and the t-derived
# factors float64 device scalars, so the weights part by an ulp at the
# first step. Each array within OPT_SHARE of the largest distance a
# weight of it moved in the eager run, but for at most OPT_BEYOND of all
# entries: rules that divide by a running magnitude plus a small epsilon
# turn an ulp into a whole step where the gradient is near 0 (Adamax's
# 1e-12: 32 of LeNet's 431,080 weights on the H100; Signum's sign of a
# momentum near 0). A factor frozen at the capture moves every entry
# (Adamax's bias correction from t = 3 to 8: 2.71 to 1.75).
OPT_SHARE = 1e-3
OPT_BEYOND = 1e-3
# SGLD adds N(0, lr) noise a step, from different generators on each
# path: (w_captured - w_eager) / sqrt(2 * OPT_STEPS * lr) over LeNet's
# 431,080 weights has mean within 0.01 of 0 and deviation within 0.02 of
# 1 (10 and 20 standard errors; noise frozen at the capture would replay
# one draw 6 times: deviation sqrt(46 / 16) = 1.7)
SGLD_MEAN_BAND, SGLD_STD_BAND = 0.01, 0.02


def opt_sweep_run(mt, name, ctx, fused, steps, w0):
    """LeNet's Module (local store: the module's Updater) from ``w0``
    trained ``steps`` steps of fit's loop body with ``name``: ({name:
    numpy} weights, module)."""
    def go():
        np.random.seed(0)
        mt.random.seed(0)
        tr_x, tr_y, _vx, _vy = lenet_data()
        it = mt.io.NDArrayIter(tr_x, tr_y, LENET_BATCH, shuffle=False)
        mod = mt.mod.Module(lenet_symbol(mt), context=ctx)
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(arg_params=host_params(mt, w0))
        mod.init_optimizer(kvstore="local", optimizer=name,
                           optimizer_params=OPT_SWEEP[name])
        fit_steps(mod, it, mt.metric.create("acc"), steps=steps)
        return module_params(mod), mod
    return with_fused(fused, go)


def share_apart(got, want, start):
    """(the share of entries past OPT_SHARE of their array's largest
    move, the worst |got - want| as a share of it)."""
    past, total, worst = 0, 0, 0.0
    for k in want:
        step = float(np.abs(want[k] - start[k]).max())
        d = np.abs(got[k] - want[k])
        limit = OPT_SHARE * step + 1e-7
        past += int((d > limit).sum())
        total += d.size
        worst = max(worst, float(d.max()) / max(step, 1e-30))
    return past / total, worst


def sgld_band(got, want, lr, steps):
    """Mean and deviation of (got - want) / sqrt(2 steps lr) over every
    weight."""
    z = np.concatenate([(got[k] - want[k]).ravel() for k in sorted(want)]) \
        / np.sqrt(2 * steps * lr)
    return float(z.mean()), float(z.std())


def optimizer_sweep_phase(mt, seed, card):
    """(b) every optimizer of the registry through LeNet's Module.fit on
    gpu(0): OPT_STEPS captured steps against OPT_STEPS eager ones, and the
    first eager step against the CPU's, with deterministic cuDNN; one line
    an optimizer, "captured" or "eager: <reason>". Returns {name:
    "captured" or the reason}."""
    import torch
    gpu = mt.gpu(0)
    names = sorted(mt.optimizer.Optimizer.opt_registry)
    if sorted(OPT_SWEEP) != names:
        fail("the optimizer sweep covers %s, the registry holds %s"
             % (sorted(OPT_SWEEP), names))
    w0 = lenet_init_params(mt, seed)
    routes = {}
    t_phase = time.time()
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name in names:
            eager, _ = opt_sweep_run(mt, name, gpu, False, OPT_STEPS, w0)
            fused, mod = opt_sweep_run(mt, name, gpu, True, OPT_STEPS, w0)
            if mod._fused is None:
                route = "eager: %s" % getattr(mod, "_fused_fallback_logged",
                                              "disabled")
            else:
                captured_steps(mod, "optimizer sweep, %s" % name, OPT_STEPS)
                route = "captured"
            routes[name] = route
            del mod
            card1, _ = opt_sweep_run(mt, name, gpu, False, 1, w0)
            cpu1, _ = opt_sweep_run(mt, name, mt.cpu(), False, 1, w0)
            lr = OPT_SWEEP[name].get("learning_rate", 0.0)
            past1, worst1 = share_apart(card1, cpu1, w0)
            if name == "sgld":
                # the eager steps on both devices draw from the thread's
                # CPU generator, seeded alike: the same noise
                mean, std = sgld_band(fused, eager, lr, OPT_STEPS)
                if not (abs(mean) <= SGLD_MEAN_BAND and
                        abs(std - 1) <= SGLD_STD_BAND) or \
                        past1 > OPT_BEYOND:
                    fail("SGLD: captured vs eager, the noise's difference "
                         "has mean %.4f and deviation %.4f of its expected "
                         "(bands %g, %g); the first step card vs CPU has "
                         "%.3g of its entries beyond %g of the move"
                         % (mean, std, SGLD_MEAN_BAND, SGLD_STD_BAND, past1,
                            OPT_SHARE))
                text = ("noise difference captured vs eager: mean %.4f, "
                        "deviation %.4f of sqrt(2 x %d x lr) (bands %g, %g); "
                        "first step card vs CPU (the same draws): %.3g of "
                        "the entries past, worst %.3g"
                        % (mean, std, OPT_STEPS, SGLD_MEAN_BAND,
                           SGLD_STD_BAND, past1, worst1))
            else:
                past, worst = share_apart(fused, eager, w0)
                if past > OPT_BEYOND or past1 > OPT_BEYOND:
                    fail("%s: %.3g of the entries captured vs eager after %d "
                         "steps and %.3g card vs CPU after 1 step lie beyond "
                         "%g of their array's move (limit %g of them)"
                         % (name, past, OPT_STEPS, past1, OPT_SHARE,
                            OPT_BEYOND))
                text = ("captured vs eager after %d steps: %.3g of the "
                        "entries past %g of the move, worst %.3g of it; "
                        "first step card vs CPU: %.3g past, worst %.3g"
                        % (OPT_STEPS, past, OPT_SHARE, worst, past1,
                           worst1))
            print("optimizer %-9s %s; %s" % (name + ":", route, text),
                  flush=True)
    finally:
        torch.backends.cudnn.deterministic = old
    print("optimizer sweep: %d optimizers through LeNet's Module.fit, %d "
          "captured; %.1f s | %s"
          % (len(names), sum(r == "captured" for r in routes.values()),
             time.time() - t_phase, card), flush=True)
    return routes


# (c) RNN checkpoints on the bucketed LSTM LM at PTB's widths (config 4),
# as upstream MXNet's example/rnn/bucketing/cudnn_lstm_bucketing.py uses
# them: trained fused with do_rnn_checkpoint (and the optimizer's states
# each epoch), scored unfused through load_rnn_checkpoint, and resumed
RC_VOCAB, RC_SENTENCES = 10000, 600
RC_EPOCHS, RC_RESUME = 3, 1
# cudnn_lstm_bucketing.py's optimizer and initializer
RC_OPT = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-5}
# the fused kernel and the LSTMCells' ops score in float32 with another
# order of sums: perplexities within 1e-4 relative
RC_PPL_RTOL = 1e-4
# resumed vs never stopped: the same steps on the same batches, but the
# embedding's gradient sums by atomics on the card, so each array within
# RC_SHARE of the largest distance it moved over the resumed epochs
RC_SHARE = 1e-3


class EpochSeededIter:
    """A data iterator whose every reset (one an epoch end) first seeds
    Python's and numpy's generators from (seed, epochs reset so far): a
    run resumed at epoch k, after k resets, serves the batches the run
    never stopped serves from its epoch k on."""

    def __init__(self, inner, seed, begin_epoch=0):
        self.inner, self.seed, self.epoch = inner, seed, 0
        self.batch_size = inner.batch_size
        self.provide_data = inner.provide_data
        self.provide_label = inner.provide_label
        self.default_bucket_key = inner.default_bucket_key
        for _ in range(begin_epoch):
            self.reset()

    def __iter__(self):
        return self

    def __next__(self):
        return self.inner.next()

    next = __next__

    def reset(self):
        self.epoch += 1
        random.seed(self.seed * 1000 + self.epoch)
        np.random.seed(self.seed * 1000 + self.epoch)
        self.inner.reset()


class FixedBatches:
    """The given DataBatches of ``source`` as an iterator, the same ones
    each pass; its shapes are ``source``'s (a bucketing iterator's: its
    default bucket's)."""

    def __init__(self, source):
        self.batches, self.i = list(source), 0
        self.provide_data = source.provide_data
        self.provide_label = source.provide_label

    def __iter__(self):
        return self

    def __next__(self):
        if self.i == len(self.batches):
            raise StopIteration
        self.i += 1
        return self.batches[self.i - 1]

    next = __next__

    def reset(self):
        self.i = 0


def rnn_ckpt_fit(mt, sentences, prefix, begin_epoch=0, arg_params=None,
                 aux_params=None, states=None, seed=0, ctx=None):
    """cudnn_lstm_bucketing.py's fit on gpu(0) (FusedRNNCell; SGD,
    Xavier(in, 2.34), Perplexity) from ``begin_epoch`` to RC_EPOCHS, each
    epoch's end saving an RNN checkpoint (do_rnn_checkpoint) and the
    optimizer's states under ``prefix``; a resumed run is bound and given
    ``arg_params`` and the ``states`` file before fit. On ``ctx``, gpu(0)
    unless given. Returns (module, iterator)."""
    random.seed(seed)
    np.random.seed(seed)
    mt.random.seed(seed)
    train = EpochSeededIter(mt.rnn.BucketSentenceIter(
        sentences, BL_BATCH, buckets=list(BL_BUCKETS), invalid_label=0),
        seed, begin_epoch)
    cell = lstm_rnn_cell(mt, True)
    mod = mt.mod.BucketingModule(
        lstm_sym_gen(mt, RC_VOCAB, True),
        default_bucket_key=train.default_bucket_key,
        context=ctx or mt.gpu(0))
    init = mt.init.Xavier(factor_type="in", magnitude=2.34)
    if states is not None:
        mod.bind(train.provide_data, train.provide_label)
        mod.init_params(init, arg_params=arg_params, aux_params=aux_params)
        mod.init_optimizer(optimizer="sgd", optimizer_params=RC_OPT)
        mod.load_optimizer_states(states)

    def save_states(epoch, *_):
        mod.save_optimizer_states("%s-%04d.states" % (prefix, epoch + 1))
    mod.fit(train, eval_metric=mt.metric.Perplexity(ignore_label=0),
            optimizer="sgd", optimizer_params=RC_OPT, initializer=init,
            arg_params=arg_params, aux_params=aux_params,
            begin_epoch=begin_epoch, num_epoch=RC_EPOCHS,
            batch_end_callback=mt.callback.Speedometer(BL_BATCH, 20,
                                                       auto_reset=False),
            epoch_end_callback=[mt.rnn.do_rnn_checkpoint(cell, prefix, 1),
                                save_states])
    return mod, train


def rnn_ckpt_scores(mt, mod, sentences, prefix, ctx=None, seed=0,
                    rnn_scan=None):
    """(i) The last checkpoint loaded into the example's unfused stack of
    LSTMCells (load_rnn_checkpoint) and the fused module ``mod`` score the
    same batches: (fused perplexity, unfused perplexity, batches, lstm_scan
    launches fused and unfused, counted from 0 before each when
    ``rnn_scan`` is given)."""
    ctx = ctx or mt.gpu(0)
    random.seed(seed + 1)
    np.random.seed(seed + 1)
    with ctx:
        score_it = mt.rnn.BucketSentenceIter(sentences, BL_BATCH,
                                             buckets=list(BL_BUCKETS),
                                             invalid_label=0)
    batches = FixedBatches(score_it)
    launches = []

    def score(module):
        if rnn_scan is not None:
            rnn_scan.reset_launches()
        ppl = dict(module.score(batches, mt.metric.Perplexity(
            ignore_label=0)))["perplexity"]
        if rnn_scan is not None:
            sync(ctx)
            launches.append(rnn_scan.LAUNCHES["lstm_scan"])
        return ppl
    fused_ppl = score(mod)
    stack = lstm_rnn_cell(mt, False)
    _sym, arg, aux = mt.rnn.load_rnn_checkpoint(stack, prefix, RC_EPOCHS)
    unfused = mt.mod.BucketingModule(
        lstm_sym_gen(mt, RC_VOCAB, False),
        default_bucket_key=score_it.default_bucket_key, context=ctx)
    unfused.bind(batches.provide_data, batches.provide_label,
                 for_training=False)
    unfused.init_params(arg_params=arg, aux_params=aux)
    return fused_ppl, score(unfused), len(batches.batches), launches


def rnn_ckpt_resume(mt, sentences, prefix, ctx=None, seed=0):
    """(ii) A run resumed at RC_RESUME from its RNN checkpoint and its
    optimizer's states, trained to RC_EPOCHS: ({name: numpy} at the
    checkpoint, {name: numpy} at the end)."""
    _sym, arg, aux = mt.rnn.load_rnn_checkpoint(lstm_rnn_cell(mt, True),
                                                prefix, RC_RESUME)
    start = {k: v.asnumpy() for k, v in arg.items()}
    resumed, _it = rnn_ckpt_fit(
        mt, sentences, prefix + "_resumed", begin_epoch=RC_RESUME,
        arg_params=arg, aux_params=aux,
        states="%s-%04d.states" % (prefix, RC_RESUME), seed=seed, ctx=ctx)
    return start, module_params(resumed)


def sync(ctx):
    """Wait for ``ctx``'s device (nothing on the CPU)."""
    import torch
    if ctx.device_type == "gpu":
        torch.cuda.synchronize()


def rnn_checkpoint_phase(mt, rnn_scan, seed, card, workdir):
    """(c) The bucketed LM at PTB's widths trained fused with RNN
    checkpoints: lstm_scan counted from 0 just before the fit (warm-up
    launches + graph nodes x replays = one a layer a step); the last
    checkpoint loaded into the example's unfused LSTMCells scores the
    same batches as the fused module (one launch a layer a batch there,
    none unfused); a run resumed at epoch RC_RESUME from its checkpoint
    and optimizer states ends at the weights of the run never stopped.
    Returns ({"lstm_scan": launches in the fit}, the sentences)."""
    t_phase = time.time()
    gpu = mt.gpu(0)
    sentences, _ = synthetic_corpus(RC_SENTENCES, RC_VOCAB, seed)
    prefix = os.path.join(workdir, "rnn_ckpt")
    rnn_scan.reset_launches()
    mod, train = rnn_ckpt_fit(mt, sentences, prefix, seed=seed)
    sync(gpu)
    launched = rnn_scan.LAUNCHES["lstm_scan"]
    report = bucket_graph_report(mt, mod)
    steps = RC_EPOCHS * len(train.inner.idx)
    launches = launched + sum(r[2]["lstm"] * r[3] for r in report.values())
    nodes = {k: r[2]["lstm"] for k, r in report.items()}
    if any(n != BL_LAYERS for n in nodes.values()) or \
            launches != BL_LAYERS * steps:
        fail("RNN checkpoint fit: lstm_scan nodes a bucket graph %s, %d "
             "launches in %d steps (want %d a graph, one a layer a step)"
             % (nodes, launches, steps, BL_LAYERS))
    final = module_params(mod)
    for epoch in range(1, RC_EPOCHS + 1):
        for ext in ("params", "states"):
            if not os.path.exists("%s-%04d.%s" % (prefix, epoch, ext)):
                fail("no %s-%04d.%s after the fit" % (prefix, epoch, ext))
    fused_ppl, unfused_ppl, n_batches, (fused_n, unfused_n) = \
        rnn_ckpt_scores(mt, mod, sentences, prefix, gpu, seed, rnn_scan)
    del mod
    if fused_n != BL_LAYERS * n_batches or unfused_n != 0:
        fail("scoring launched lstm_scan %d times fused, %d unfused, for %d "
             "batches (want %d, 0)" % (fused_n, unfused_n, n_batches,
                                       BL_LAYERS * n_batches))
    if not abs(unfused_ppl - fused_ppl) <= RC_PPL_RTOL * fused_ppl:
        fail("the checkpoint scores perplexity %.6f unfused, %.6f fused "
             "(limit %g relative)" % (unfused_ppl, fused_ppl, RC_PPL_RTOL))
    start, again = rnn_ckpt_resume(mt, sentences, prefix, gpu, seed)
    worst = step_share_check("RNN checkpoint: resumed at epoch %d vs the "
                             "run never stopped" % RC_RESUME, again, final,
                             start, RC_SHARE, 1e-7)
    print("RNN checkpoints (PTB widths: vocabulary %d, embed and hidden %d, "
          "%d layers, buckets %s, batch %d; FusedRNNCell, SGD): %d epochs of "
          "%d steps, do_rnn_checkpoint and the optimizer's states each "
          "epoch; lstm_scan %d launches (%d at warm-up + %s nodes x "
          "replays); the last checkpoint scores perplexity %.6f through the "
          "unfused LSTMCells, %.6f fused (%d launches for %d batches; limit "
          "%g relative); resumed at epoch %d to %d: within %.3g of the "
          "limit (%g of each array's move); %.1f s | %s"
          % (RC_VOCAB, BL_HIDDEN, BL_LAYERS, list(BL_BUCKETS), BL_BATCH,
             RC_EPOCHS, len(train.inner.idx), launches, launched, nodes,
             unfused_ppl, fused_ppl, fused_n, n_batches, RC_PPL_RTOL,
             RC_RESUME, RC_EPOCHS, worst, RC_SHARE, time.time() - t_phase,
             card), flush=True)
    return {"lstm_scan": launches}, sentences


# (d) the examples: example/module/sequential_module.py,
# example/module/python_loss.py, example/python-howto/monitor_weights.py
# (each imports mxtpu: mirrored here line for line), and upstream MXNet's
# python_loss.py chain, a Module and a PythonLossModule in a
# SequentialModule

def four_class_data(n=512, seed=3):
    """The module examples' synthetic data: 32 features of noise below
    0.1 with a block of +1 at the class's 8 columns, 4 classes."""
    r = np.random.RandomState(seed)
    y = (r.rand(n) * 4).astype("f")
    x = r.rand(n, 32).astype("f") * 0.1
    for i in range(n):
        x[i, int(y[i]) * 8:int(y[i]) * 8 + 8] += 1.0
    return x, y


def sequential_main(pkg, ctx, arg_params=None, num_epoch=4):
    """example/module/sequential_module.py's main on ``ctx``, from given
    weights ({name: numpy}) if any: (score, the chain)."""
    np.random.seed(0)
    x, y = four_class_data(512, 3)
    feat = pkg.sym.Activation(
        pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=32,
                               name="feat_fc"), act_type="relu")
    head = pkg.sym.SoftmaxOutput(
        pkg.sym.FullyConnected(pkg.sym.Variable("feat"), num_hidden=4,
                               name="head_fc"), name="softmax")
    seq = pkg.mod.SequentialModule()
    seq.add(pkg.mod.Module(feat, label_names=(), context=ctx))
    seq.add(pkg.mod.Module(head, data_names=("feat",), context=ctx),
            take_labels=True, auto_wiring=True)
    it = pkg.io.NDArrayIter(x, y, batch_size=64, shuffle=True,
                            label_name="softmax_label")
    seq.fit(it, num_epoch=num_epoch, optimizer="sgd",
            optimizer_params={"learning_rate": 0.3},
            initializer=pkg.init.Xavier(),
            arg_params=host_params(pkg, arg_params))
    score = seq.score(it, pkg.metric.Accuracy())
    if not dict(score)["accuracy"] > 0.9:
        fail("sequential_module.py: accuracy %s (the example asserts > 0.9)"
             % score)
    return score, seq


def python_loss_main(pkg, ctx):
    """example/module/python_loss.py's main on ``ctx``: MakeLoss over a
    written-out weighted cross-entropy through Module, then a numpy
    gradient through an executor's backward(out_grads). Returns (the
    MakeLoss route's last epoch loss, the numpy route's first and last
    losses)."""
    np.random.seed(0)
    x, y = four_class_data(512, 1)
    data = pkg.sym.Variable("data")
    label = pkg.sym.Variable("softmax_label")
    fc = pkg.sym.FullyConnected(data, num_hidden=4, name="fc")
    p = pkg.sym.softmax(fc)
    onehot = pkg.sym.one_hot(label, depth=4)
    ce = -pkg.sym.sum(onehot * pkg.sym.log(p + 1e-8), axis=1)
    loss = pkg.sym.MakeLoss(ce * 0.5)
    mod = pkg.mod.Module(loss, context=ctx, label_names=("softmax_label",))
    it = pkg.io.NDArrayIter(x, y, batch_size=64, shuffle=True,
                            label_name="softmax_label")
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(pkg.init.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.5})
    for epoch in range(4):
        it.reset()
        total, n = 0.0, 0
        for batch in it:
            mod.forward(batch, is_train=True)
            total += float(mod.get_outputs()[0].asnumpy().mean())
            n += 1
            mod.backward()
            mod.update()
    makeloss = total / n
    if not makeloss < 0.4:
        fail("python_loss.py: MakeLoss loss %.4f (the example asserts < "
             "0.4)" % makeloss)
    fc_only = pkg.sym.FullyConnected(pkg.sym.Variable("data"),
                                     num_hidden=4, name="fc")
    ex = fc_only.simple_bind(ctx, data=(64, 32))
    r = np.random.RandomState(0)
    for k, v in ex.arg_dict.items():
        if k != "data":
            v[:] = r.uniform(-0.1, 0.1, v.shape).astype("f")
    losses = []
    for step in range(80):
        i = (step * 64) % (len(x) - 64)
        xb, yb = x[i:i + 64], y[i:i + 64].astype(int)
        ex.arg_dict["data"][:] = xb
        logits = ex.forward(is_train=True)[0].asnumpy()
        e = np.exp(logits - logits.max(1, keepdims=True))
        prob = e / e.sum(1, keepdims=True)
        losses.append(float(-np.log(prob[np.arange(64), yb] + 1e-8).mean()))
        grad = prob.copy()
        grad[np.arange(64), yb] -= 1.0
        ex.backward([pkg.nd.array(grad / 64, ctx=ctx)])
        for k in ex.arg_dict:
            if k != "data":
                ex.arg_dict[k][:] = ex.arg_dict[k] - 0.5 * ex.grad_dict[k]
    if not losses[-1] < losses[0] * 0.5:
        fail("python_loss.py: numpy-gradient loss %.4f -> %.4f (the example "
             "asserts a halving)" % (losses[0], losses[-1]))
    return makeloss, losses[0], losses[-1]


def mc_hinge_grad(scores, labels):
    """upstream python_loss.py's multi-class hinge gradient (written there
    under numba.jit; here in numpy over the port's or mxtpu's arrays)."""
    scores = scores.asnumpy()
    labels = labels.asnumpy().astype(int)
    n, _ = scores.shape
    grad = np.zeros_like(scores)
    for i in range(n):
        score = 1 + scores[i] - scores[i, labels[i]]
        score[labels[i]] = 0
        ind_pred = score.argmax()
        grad[i, labels[i]] -= 1
        grad[i, ind_pred] += 1
    return grad


PL_SAMPLES, PL_BATCH, PL_EPOCHS = 6000, 100, 10


def python_loss_chain(pkg, ctx, arg_params=None, num_epoch=PL_EPOCHS,
                      steps=None):
    """upstream MXNet's example/module/python_loss.py: an MLP (128, 64, 10
    hidden units) Module and a PythonLossModule(grad_func=mc_hinge_grad)
    in a SequentialModule, take_labels and auto_wiring on the loss, fit
    with SGD lr 0.01 momentum 0.9 over synthetic digits (MNIST's shape;
    the repository has no MNIST files). With ``steps``, that many
    forward/backward/update steps instead of fit. Returns (the chain, the
    train iterator)."""
    np.random.seed(0)
    x, y = synthetic_mnist(PL_SAMPLES, seed=2)
    x = x.reshape(PL_SAMPLES, -1)
    data = pkg.symbol.Variable("data")
    fc1 = pkg.symbol.FullyConnected(data, name="fc1", num_hidden=128)
    act1 = pkg.symbol.Activation(fc1, name="relu1", act_type="relu")
    fc2 = pkg.symbol.FullyConnected(act1, name="fc2", num_hidden=64)
    act2 = pkg.symbol.Activation(fc2, name="relu2", act_type="relu")
    fc3 = pkg.symbol.FullyConnected(act2, name="fc3", num_hidden=10)
    mlp = pkg.mod.Module(fc3, context=ctx)
    loss = pkg.mod.PythonLossModule(grad_func=mc_hinge_grad)
    mod = pkg.mod.SequentialModule().add(mlp).add(loss, take_labels=True,
                                                  auto_wiring=True)
    train = pkg.io.NDArrayIter(x, y, PL_BATCH, shuffle=True,
                               label_name="softmax_label")
    opt = {"learning_rate": 0.01, "momentum": 0.9}
    if steps is None:
        mod.fit(train, eval_data=None, optimizer_params=opt,
                num_epoch=num_epoch, arg_params=host_params(pkg, arg_params))
        return mod, train
    mod.bind(train.provide_data, train.provide_label)
    mod.init_params(pkg.init.Uniform(0.01),
                    arg_params=host_params(pkg, arg_params))
    mod.init_optimizer(optimizer_params=opt)
    for _ in range(steps):
        batch = train.next()
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
    return mod, train


def monitor_weights_main(pkg, ctx, arg_params=None):
    """example/python-howto/monitor_weights.py's main on ``ctx`` (the
    example names mx.monitor.Monitor), from given weights if any: the
    (step, name, value) triples the Monitor returned."""
    sym = pkg.sym.SoftmaxOutput(
        pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=4,
                               name="fc"), name="softmax")
    mon = pkg.monitor.Monitor(interval=1, stat_func=lambda a:
                              pkg.nd.norm(a) / np.sqrt(a.size))
    mod = pkg.mod.Module(sym, context=ctx)
    r = np.random.RandomState(0)
    x = r.rand(64, 8).astype("f")
    y = (r.rand(64) * 4).astype("f")
    it = pkg.io.NDArrayIter(x, y, batch_size=32,
                            label_name="softmax_label")
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(pkg.init.Xavier(), arg_params=host_params(pkg,
                                                              arg_params))
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    mod.install_monitor(mon)
    seen = []
    for batch in it:
        mon.tic()
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        seen.extend(mon.toc())
    if not any("fc" in k for _, k, _v in seen):
        fail("monitor_weights.py: no fc statistic among %s" % seen)
    return seen


def module_examples_phase(mt, card):
    """(d) the three examples' mains on gpu(0) to their own asserts, and
    upstream's python_loss.py chain trained there through fit (its
    training accuracy, read by the chain's update_metric, above 0.9).
    Returns {example: seconds}."""
    gpu = mt.gpu(0)
    secs = {}
    with gpu:
        t0 = time.time()
        score, _seq = sequential_main(mt, gpu)
        secs["sequential_module"] = time.time() - t0
        print("sequential_module.py's main on gpu(0): accuracy %.4f, its "
              "assert (> 0.9) holds; %.1f s | %s"
              % (dict(score)["accuracy"], secs["sequential_module"], card),
              flush=True)
        t0 = time.time()
        makeloss, first, last = python_loss_main(mt, gpu)
        secs["python_loss"] = time.time() - t0
        print("python_loss.py's main on gpu(0): MakeLoss loss %.4f (< 0.4), "
              "numpy-gradient loss %.4f -> %.4f (halved); %.1f s | %s"
              % (makeloss, first, last, secs["python_loss"], card),
              flush=True)
        t0 = time.time()
        seen = monitor_weights_main(mt, gpu)
        secs["monitor_weights"] = time.time() - t0
        print("monitor_weights.py's main on gpu(0): %d statistics, e.g. %s; "
              "%.1f s | %s" % (len(seen), seen[:3], secs["monitor_weights"],
                               card), flush=True)
        t0 = time.time()
        chain, train = python_loss_chain(mt, gpu)
        acc = dict(chain.score(train, mt.metric.Accuracy()))["accuracy"]
        secs["python_loss chain"] = time.time() - t0
        if not acc > 0.9:
            fail("upstream python_loss.py's chain: accuracy %.4f after %d "
                 "epochs (limit 0.9)" % (acc, PL_EPOCHS))
        mlp = chain._modules[0]
        if mlp._context != [gpu] or mlp.inputs_need_grad:
            fail("the chain's MLP is bound on %s (inputs_need_grad %s)"
                 % (mlp._context, mlp.inputs_need_grad))
        print("upstream python_loss.py's chain (Module + PythonLossModule in "
              "a SequentialModule, mc_hinge_grad) through fit on gpu(0): %d "
              "epochs, accuracy %.4f (limit 0.9); %.1f s | %s"
              % (PL_EPOCHS, acc, secs["python_loss chain"], card),
              flush=True)
    return secs


# ---------------------------------------------------------------------------
# Phase 30 (ROADMAP A8): the two examples that train with CTC through the
# fused RNN op, example/ctc/ctc_toy.py (lstm_scan) and
# example/speech_recognition/deepspeech_toy.py (gru_scan). Both import
# mxtpu, so they are mirrored here, line for line, for either package; the
# context is a parameter where the example leaves it to the default (ctc)
# or hard-codes cpu() (deepspeech_toy).
# ---------------------------------------------------------------------------

CTC_ALPHABET, CTC_LABEL_LEN, CTC_FRAMES_PER = 5, 4, 3
CTC_T = CTC_LABEL_LEN * CTC_FRAMES_PER
CTC_FEAT, CTC_HIDDEN, CTC_EPOCHS = 8, 24, 25
DST_ALPHABET, DST_LABEL_LEN, DST_FEAT, DST_HIDDEN = 4, 3, 10, 32
DST_BUCKETS, DST_EPOCHS = (9, 12), 10


def ctc_toy_data(n, seed):
    """ctc_toy.py's make_data: label sequences of 4 over symbols 1..5,
    each symbol a noisy prototype repeated 3 frames."""
    protos = np.random.RandomState(0).uniform(
        -1, 1, (CTC_ALPHABET + 1, CTC_FEAT)).astype(np.float32)
    r = np.random.RandomState(seed)
    labels = r.randint(1, CTC_ALPHABET + 1, (n, CTC_LABEL_LEN))
    frames = protos[np.repeat(labels, CTC_FRAMES_PER, axis=1)]
    frames = frames + 0.25 * r.randn(n, CTC_T, CTC_FEAT).astype(np.float32)
    return frames.astype(np.float32), labels.astype(np.float32)


def ctc_toy_symbol(pkg):
    """ctc_toy.py's build: a FusedRNNCell LSTM, a per-frame
    FullyConnected, mean ctc_loss under MakeLoss, the logits blocked."""
    S = pkg.sym
    data, label = S.var("data"), S.var("label")
    lstm = pkg.rnn.FusedRNNCell(CTC_HIDDEN, mode="lstm", prefix="lstm_")
    out, _ = lstm.unroll(CTC_T, inputs=data, layout="NTC",
                         merge_outputs=True)
    pred = S.Reshape(out, shape=(-1, CTC_HIDDEN))
    pred = S.FullyConnected(pred, num_hidden=CTC_ALPHABET + 1, name="fc")
    pred = S.Reshape(pred, shape=(-1, CTC_T, CTC_ALPHABET + 1))
    ctc_in = S.transpose(pred, axes=(1, 0, 2))
    loss = S.MakeLoss(S.mean(S.ctc_loss(ctc_in, label)))
    return S.Group([loss, S.BlockGrad(pred)])


def greedy_decode(logits):
    """Both examples' best path: argmax a frame, repeats collapsed, blanks
    dropped."""
    out = []
    for row in logits.argmax(axis=-1):
        seq, prev = [], -1
        for s in row:
            if s != prev and s != 0:
                seq.append(int(s))
            prev = s
        out.append(seq)
    return out


def ctc_loss_metric(pkg):
    """ctc_toy.py's CTCLossMetric for ``pkg``: the mean of output 0 (the
    MakeLoss scalar) a batch; ``values`` keeps each batch's."""
    class CTCLossMetric(pkg.metric.EvalMetric):
        def __init__(self):
            super(CTCLossMetric, self).__init__("ctc-loss")
            self.values = []

        def update(self, labels, preds):
            v = float(preds[0].asnumpy().mean())
            self.values.append(v)
            self.sum_metric += v
            self.num_inst += 1
    return CTCLossMetric()


def ctc_toy_main(pkg, ctx, num_epoch=CTC_EPOCHS):
    """ctc_toy.py's main on ``ctx``: Module.fit with Adam for 25 epochs,
    then greedy decoding of 256 held-out sequences. Fails unless the
    exact-sequence accuracy is above 0.9, as the example asserts. Returns
    (accuracy, the module)."""
    pkg.random.seed(41)
    np.random.seed(41)
    xtr, ytr = ctc_toy_data(1024, 1)
    xte, yte = ctc_toy_data(256, 2)
    batch = 64
    train = pkg.io.NDArrayIter(xtr, ytr, batch, shuffle=True,
                               label_name="label")
    mod = pkg.mod.Module(ctc_toy_symbol(pkg), data_names=("data",),
                         label_names=("label",), context=ctx)
    mod.fit(train, optimizer="adam",
            optimizer_params={"learning_rate": 5e-3},
            eval_metric=ctc_loss_metric(pkg), num_epoch=num_epoch)
    val = pkg.io.NDArrayIter(xte, yte, batch, label_name="label")
    exact = total = 0
    for b in val:
        mod.forward(b, is_train=False)
        logits = mod.get_outputs()[1].asnumpy()
        labs = b.label[0].asnumpy()
        k = batch - (b.pad or 0)
        for d, t in zip(greedy_decode(logits[:k]), labs[:k]):
            exact += d == list(map(int, t))
            total += 1
    acc = exact / total
    if not acc > 0.9:
        fail("ctc_toy on %s: exact-sequence accuracy %.3f (the example "
             "asserts above 0.9)" % (ctx, acc))
    return acc, mod


def dst_utterances(n, seed):
    """deepspeech_toy.py's make_utterances: token i emits 2-4 noisy frames
    of its prototype."""
    protos = np.random.RandomState(7).uniform(-1, 1,
                                              (DST_ALPHABET + 1, DST_FEAT))
    rng = np.random.RandomState(seed)
    feats, labels = [], []
    for _ in range(n):
        lab = rng.randint(1, DST_ALPHABET + 1, (DST_LABEL_LEN,))
        frames = []
        for tok in lab:
            frames += [protos[tok]] * rng.randint(2, 5)
        arr = np.asarray(frames, np.float32)
        arr = arr + 0.2 * rng.randn(*arr.shape)
        feats.append(arr.astype(np.float32))
        labels.append(lab.astype(np.float32))
    return feats, labels


def speech_iter(pkg, feats, labels, batch_size, buckets, feat_dim,
                label_len):
    """deepspeech_toy.py's BucketSpeechIter for ``pkg`` (the reference's
    STTIter): each utterance zero-padded to the first bucket it fits,
    whole batches a bucket, their order shuffled by numpy's global RNG at
    each reset; labels padded with 0 (blank) to ``label_len``."""
    io = pkg.io

    class BucketSpeechIter(io.DataIter):
        def __init__(self):
            super().__init__(batch_size)
            self.buckets = sorted(buckets)
            self.data = {b: [] for b in self.buckets}
            for f, lab in zip(feats, labels):
                for b in self.buckets:
                    if len(f) <= b:
                        pad = np.zeros((b, feat_dim), np.float32)
                        pad[:len(f)] = f
                        padded = np.zeros(label_len, np.float32)
                        padded[:len(lab)] = lab
                        self.data[b].append((pad, padded))
                        break
            self.default_bucket_key = self.buckets[-1]
            self.reset()

        @property
        def provide_data(self):
            return [io.DataDesc("data", (self.batch_size,
                                         self.default_bucket_key, feat_dim))]

        @property
        def provide_label(self):
            return [io.DataDesc("label", (self.batch_size, label_len))]

        def reset(self):
            self._plan = []
            for b in self.buckets:
                for i in range(0, len(self.data[b]) - self.batch_size + 1,
                               self.batch_size):
                    self._plan.append((b, i))
            np.random.shuffle(self._plan)
            self._cursor = 0

        def next(self):
            if self._cursor >= len(self._plan):
                raise StopIteration
            b, i = self._plan[self._cursor]
            self._cursor += 1
            chunk = self.data[b][i:i + self.batch_size]
            x = np.stack([c[0] for c in chunk])
            y = np.stack([c[1] for c in chunk])
            return io.DataBatch(
                data=[pkg.nd.array(x)], label=[pkg.nd.array(y)],
                bucket_key=b, provide_data=[io.DataDesc("data", x.shape)],
                provide_label=[io.DataDesc("label", y.shape)])
    return BucketSpeechIter()


def dst_sym_gen(pkg):
    """deepspeech_toy.py's sym_gen: a 3x3 convolution over the
    time-frequency plane, a bidirectional FusedRNNCell GRU, a per-frame
    FullyConnected, mean ctc_loss under MakeLoss, the logits blocked."""
    S = pkg.sym

    def sym_gen(seq_len):
        data, label = S.var("data"), S.var("label")
        body = S.Reshape(data, shape=(0, 1, seq_len, DST_FEAT))
        body = S.Convolution(body, num_filter=8, kernel=(3, 3), pad=(1, 1),
                             name="conv1")
        body = S.Activation(body, act_type="relu")
        body = S.Reshape(S.transpose(body, axes=(0, 2, 1, 3)),
                         shape=(0, seq_len, -1))
        rnn = pkg.rnn.FusedRNNCell(DST_HIDDEN, mode="gru",
                                   bidirectional=True, prefix="bgru_")
        out, _ = rnn.unroll(seq_len, inputs=body, layout="NTC",
                            merge_outputs=True)
        pred = S.Reshape(out, shape=(-1, 2 * DST_HIDDEN))
        pred = S.FullyConnected(pred, num_hidden=DST_ALPHABET + 1, name="fc")
        pred = S.Reshape(pred, shape=(-1, seq_len, DST_ALPHABET + 1))
        ctc_in = S.transpose(pred, axes=(1, 0, 2))
        loss = S.MakeLoss(S.mean(S.ctc_loss(ctc_in, label)))
        return S.Group([loss, S.BlockGrad(pred)]), ("data",), ("label",)
    return sym_gen


def dst_module(pkg, ctx, train):
    mod = pkg.mod.BucketingModule(dst_sym_gen(pkg),
                                  default_bucket_key=train.default_bucket_key,
                                  context=ctx)
    mod.bind(train.provide_data, train.provide_label)
    return mod


def dst_main(pkg, ctx, epochs=DST_EPOCHS, arg_params=None, steps=None):
    """deepspeech_toy.py's main on ``ctx``: a BucketingModule over two
    buckets, Xavier (or ``arg_params``), Adam, ``epochs`` epochs of
    forward / backward / update, then greedy decoding of one batch a
    bucket. Fails unless the last epoch's CTC loss is below 0.35 of the
    first's and the exact-transcript match above 0.75, as the example
    asserts. With ``steps``, the first ``steps`` steps only: their losses
    and the weights after them."""
    pkg.random.seed(3)
    np.random.seed(3)
    feats, labels = dst_utterances(512, 1)
    batch = 32
    train = speech_iter(pkg, feats, labels, batch, DST_BUCKETS, DST_FEAT,
                        DST_LABEL_LEN)
    mod = dst_module(pkg, ctx, train)
    mod.init_params(pkg.init.Xavier(),
                    arg_params=host_params(pkg, arg_params),
                    allow_missing=arg_params is None)
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 0.01})
    first = last = None
    losses = []
    for epoch in range(epochs):
        train.reset()
        total, count = 0.0, 0
        for b in train:
            mod.forward(b)
            mod.backward()
            mod.update()
            losses.append(float(mod.get_outputs()[0].asnumpy().mean()))
            total += losses[-1]
            count += 1
            if steps is not None and len(losses) == steps:
                return losses, module_params(mod)
        avg = total / count
        first = avg if first is None else first
        last = avg
    if not last < first * 0.35:
        fail("deepspeech_toy on %s: CTC loss %.4f -> %.4f (the example "
             "asserts below 0.35 of the first epoch's)" % (ctx, first, last))
    train.reset()
    hits = total = 0
    seen = set()
    for b in train:
        if b.bucket_key in seen:
            continue
        seen.add(b.bucket_key)
        mod.forward(b, is_train=False)
        decoded = greedy_decode(mod.get_outputs()[1].asnumpy())
        want = b.label[0].asnumpy().astype(int).tolist()
        for d, w in zip(decoded, want):
            hits += int(d == w)
            total += 1
    rate = hits / total
    if not rate > 0.75:
        fail("deepspeech_toy on %s: exact transcript match %.3f (the "
             "example asserts above 0.75)" % (ctx, rate))
    return first, last, rate


def dst_init(pkg):
    """The toy's Xavier weights drawn on the CPU from seed 0: {name:
    numpy}, the weights both devices' first steps start from."""
    pkg.random.seed(0)
    np.random.seed(3)
    feats, labels = dst_utterances(64, 1)
    with pkg.cpu():
        train = speech_iter(pkg, feats, labels, 32, DST_BUCKETS, DST_FEAT,
                            DST_LABEL_LEN)
        mod = dst_module(pkg, pkg.cpu(), train)
        mod.init_params(pkg.init.Xavier())
    return module_params(mod)


def scan_launches(mt, rnn_scan, graphs):
    """{kernel: launches} since the counts were set to 0: the eager
    launches, plus each captured graph's time-loop nodes times its replays
    (``graphs``: (CUDA graph, replays) pairs)."""
    out = dict(rnn_scan.LAUNCHES)
    names = {}
    for graph, replays in graphs:
        funcs, _others = mt._nvrtc.graph_kernel_functions(
            graph.raw_cuda_graph())
        for f in funcs:
            if f not in names:
                names[f] = mt._nvrtc.function_name(f)
            label = rnn_kernel_label(names[f])
            if label:
                out[label.split()[0] + "_scan"] += replays
    return out


def ctc_examples_phase(mt, rnn_scan, card):
    """Phase 30: both CTC examples' first steps on gpu(0) against the CPU
    from weights drawn on the CPU (each array within EX_SHARE of its
    largest value, or EX_FLOOR of the example's largest), then each main
    on gpu(0) to its own asserts, lstm_scan and gru_scan counted from 0
    just before each. Returns {kernel: launches} over both mains."""
    gpu = mt.gpu(0)
    t0 = time.time()
    firsts = {}
    np.random.seed(41)
    x, y = ctc_toy_data(256, 1)
    with mt.cpu():
        it = mt.io.NDArrayIter(x, y, 64, shuffle=True, label_name="label")
        with mt.name.NameManager():
            sym = ctc_toy_symbol(mt)
        args, auxs = module_init(mt, sym, it, mt.init.Xavier(),
                                 label_names=("label",))
        dargs = dst_init(mt)
    for label, ctx in (("gpu", gpu), ("cpu", mt.cpu())):
        with ctx:
            firsts[label] = {
                "ctc_toy": module_delta(module_steps(
                    mt, ctx, sym, it, args, auxs, "adam",
                    {"learning_rate": 5e-3}, label_names=("label",)), args),
                "deepspeech_toy": (lambda r: dict(
                    module_delta(r[1], dargs), losses=np.array(r[0])))(
                    dst_main(mt, ctx, arg_params=dargs, steps=FIT_STEPS))}
    for ex, got in firsts["gpu"].items():
        want = firsts["cpu"][ex]
        top = max(float(np.abs(w).max()) for w in want.values())
        worst = 0.0
        for k, w in want.items():
            w = np.asarray(w, np.float64)
            err = float(np.abs(np.asarray(got[k], np.float64) - w).max()) \
                / max(float(np.abs(w).max()), EX_FLOOR * top, 1e-30)
            worst = max(worst, err)
            if not err <= EX_SHARE:
                fail("%s: %s after %d steps on gpu(0) differs from the CPU's "
                     "by %.3g of its largest value (limit %g)"
                     % (ex, k, FIT_STEPS, err, EX_SHARE))
        print("%s: first %d steps on gpu(0) against the CPU: %d arrays within "
              "%.3g of their largest values (limit %g)"
              % (ex, FIT_STEPS, len(want), worst, EX_SHARE), flush=True)
    first_s = time.time() - t0
    launches = {"lstm_scan": 0, "gru_scan": 0}
    with gpu:
        t0 = time.time()
        rnn_scan.reset_launches()
        acc, mod = ctc_toy_main(mt, gpu)
        entries = [e for e in mod._fused._cache.entries()
                   if e.graph is not None] if mod._fused else []
        got = scan_launches(mt, rnn_scan, [(e.graph, e.replays)
                                           for e in entries])
        steps = CTC_EPOCHS * (1024 // 64)
        if got["lstm_scan"] < steps or got["gru_scan"]:
            fail("ctc_toy: launches %s in %d training steps (want at least "
                 "one lstm_scan a step, no gru_scan)" % (got, steps))
        print("ctc_toy's main on gpu(0) (Module.fit, %s): exact-sequence "
              "accuracy %.3f, its assert holds; launches %s (%d steps and "
              "the held-out forwards); %.1f s | %s"
              % ("captured: %d graph(s), %d replays" % (
                  len(entries), sum(e.replays for e in entries))
                 if entries else "eager", acc, got, steps,
                 time.time() - t0, card), flush=True)
        for k in launches:
            launches[k] += got[k]
        t0 = time.time()
        rnn_scan.reset_launches()
        first, last, rate = dst_main(mt, gpu)
        got = dict(rnn_scan.LAUNCHES)
        if got["gru_scan"] < 1 or got["lstm_scan"]:
            fail("deepspeech_toy: launches %s (want gru_scan, no lstm_scan)"
                 % got)
        print("deepspeech_toy's main on gpu(0) (BucketingModule, eager "
              "forward / backward / update): CTC loss %.4f -> %.4f (limit "
              "0.35 x), exact transcript match %.3f (limit 0.75), its "
              "asserts hold; launches %s; %.1f s | %s"
              % (first, last, rate, got, time.time() - t0, card), flush=True)
        for k in launches:
            launches[k] += got[k]
    print("CTC examples phase: first steps %.1f s" % first_s, flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 31: DeepSpeech 2 at its published widths (Amodei et al., Deep
# Speech 2, arXiv:1512.02595), as MXNet v1.x example/speech_recognition
# builds it (arch_deepspeech.py, deepspeech.cfg [arch]): 161 spectrogram
# bins, two convolutions of 32 channels (11x41 at stride (2, 2), 11x21 at
# stride (1, 2), each with BatchNorm and ReLU), 3 bidirectional GRU layers
# of 1,760 units a direction (a FusedRNNCell, gru_scan at H=1760 in its
# streamed mode), a per-frame FullyConnected to 29 symbols (blank, 26
# letters, space, apostrophe) and ctc_loss; batch 12, buckets of 200 and
# 300 frames. About 145M weights in float32. Random weights from a seed
# and synthetic utterances (each character a few noisy frames of its own
# 161-bin prototype): no LibriSpeech in the repository.
# ---------------------------------------------------------------------------

DS2 = dict(bins=161, hidden=1760, layers=3, classes=29, batch=12,
           buckets=(200, 300))
# (channels, kernel, stride, pad) of the two convolutions; the pads keep
# T / 2 frames and 41 frequency rows: GRU layer 1 reads 32 x 41 = 1,312
DS2_CONV = ((32, (11, 41), (2, 2), (5, 20)), (32, (11, 21), (1, 2), (5, 10)))
DS2_LABEL = 36                  # labels padded with blanks to this
DS2_UTTERANCES = 60             # a bucket: 5 batches of 12
DS2_EAGER_UTTERANCES = 36       # the eager fit's: 3 batches a bucket
DS2_LR, DS2_CLIP = 3e-4, 100.0  # Adam; deepspeech.cfg's clip_gradient
DS2_CAPTURED_EPOCHS = 2
# the first step at batch 2 and bucket 200 on the card against the CPU
# (TF32 off): the loss within DS2_LOSS_RTOL, each gradient within
# DS2_GRAD_SHARE of its largest entry (float32 sums in another order over
# 100 recurrent steps and 3 layers)
DS2_CHECK_BATCH, DS2_LOSS_RTOL, DS2_GRAD_SHARE = 2, 1e-4, 1e-3
# the first captured steps against eager ones from the same weights: each
# step's CTC loss within this (relative)
DS2_STEP_RTOL = 1e-4
# the loss falls: the mean of the captured fit's last 4 steps below
# DS2_FALL of its first 4's
DS2_FALL = 0.7


def ds2_frames(seq_len):
    """Frames after the convolutions: the first's stride 2, the second's
    stride 1 (both padded by 5 in time)."""
    return (seq_len - 1) // 2 + 1


def ds2_widths(bins=None, hidden=None, layers=None, classes=None):
    """The widths given, DS2's where not."""
    return (DS2["bins"] if bins is None else bins,
            DS2["hidden"] if hidden is None else hidden,
            DS2["layers"] if layers is None else layers,
            DS2["classes"] if classes is None else classes)


def ds2_symbol(pkg, seq_len, bins=None, hidden=None, layers=None,
               classes=None):
    """arch_deepspeech.py's acoustic model for a bucket of ``seq_len``
    frames (DS2's widths where none are given), with ctc_loss's mean
    under MakeLoss and the per-frame logits blocked (as the toy's
    sym_gen)."""
    bins, hidden, layers, classes = ds2_widths(bins, hidden, layers, classes)
    S = pkg.sym
    data, label = S.var("data"), S.var("label")
    body = S.Reshape(data, shape=(0, 1, seq_len, bins))
    for i, (channels, kernel, stride, pad) in enumerate(DS2_CONV):
        body = S.Convolution(body, num_filter=channels, kernel=kernel,
                             stride=stride, pad=pad, no_bias=True,
                             name="conv%d" % (i + 1))
        body = S.BatchNorm(body, fix_gamma=False, name="conv%d_bn" % (i + 1))
        body = S.Activation(body, act_type="relu")
    steps = ds2_frames(seq_len)
    body = S.Reshape(S.transpose(body, axes=(0, 2, 1, 3)),
                     shape=(0, steps, -1))
    rnn = pkg.rnn.FusedRNNCell(hidden, num_layers=layers, mode="gru",
                               bidirectional=True, prefix="bgru_")
    out, _ = rnn.unroll(steps, inputs=body, layout="NTC",
                        merge_outputs=True)
    pred = S.Reshape(out, shape=(-1, 2 * hidden))
    pred = S.FullyConnected(pred, num_hidden=classes, name="fc")
    pred = S.Reshape(pred, shape=(-1, steps, classes))
    loss = S.MakeLoss(S.mean(S.ctc_loss(S.transpose(pred, axes=(1, 0, 2)),
                                        label)))
    return S.Group([loss, S.BlockGrad(pred)])


def ds2_sym_gen(pkg):
    def sym_gen(seq_len):
        return ds2_symbol(pkg, seq_len), ("data",), ("label",)
    return sym_gen


def ds2_utterances(n, seed, bucket, bins=None):
    """``n`` utterances for the bucket of ``bucket`` frames: a label of
    bucket / 10 to bucket / 8.5 characters over symbols 1..classes-1, each
    character 7 or 8 noisy frames of its own prototype (at 200 frames
    140-184, at 300 210-280: each bucket's utterances fall in it)."""
    bins, _, _, classes = ds2_widths(bins=bins)
    protos = np.random.RandomState(7).uniform(-1, 1, (classes, bins))
    rng = np.random.RandomState(seed)
    feats, labels = [], []
    for _ in range(n):
        lab = rng.randint(1, classes, rng.randint(bucket // 10,
                                                  bucket * 2 // 17 + 1))
        frames = np.concatenate([np.repeat(protos[t][None], rng.randint(7, 9),
                                           axis=0) for t in lab])
        frames = frames + 0.3 * rng.randn(*frames.shape)
        feats.append(frames.astype(np.float32))
        labels.append(lab.astype(np.float32))
    return feats, labels


def ds2_data(seed, per_bucket):
    """(features, labels) over DS2's buckets, ``per_bucket`` each."""
    feats, labels = [], []
    for i, b in enumerate(DS2["buckets"]):
        f, lab = ds2_utterances(per_bucket, seed + i, b)
        feats += f
        labels += lab
    return feats, labels


def ds2_init(shapes, seed):
    """Weights from ``seed``: each weight uniform in +-sqrt(6 / (fan in +
    fan out)) (the GRU's flat blob at its recurrent scale, 1 /
    sqrt(hidden)), BatchNorm's gamma 1 and beta 0; {name: numpy}."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in sorted(shapes.items()):
        if name in ("data", "label"):
            continue
        if name.endswith("gamma"):
            out[name] = np.ones(shape, np.float32)
        elif name.endswith("beta") or name.endswith("bias"):
            out[name] = np.zeros(shape, np.float32)
        else:
            if len(shape) == 1:
                a = 1.0 / np.sqrt(DS2["hidden"])
            else:
                fan_in = int(np.prod(shape[1:]))
                a = np.sqrt(6.0 / (fan_in + shape[0]))
            out[name] = rng.uniform(-a, a, shape).astype(np.float32)
    return out


def ds2_shapes(pkg, bucket, batch, **widths):
    """{argument or aux name: shape} of the bucket's symbol at ``batch``."""
    sym = ds2_symbol(pkg, bucket, **widths)
    arg, _, aux = sym.infer_shape(data=(batch, bucket, ds2_widths(
        widths.get("bins"))[0]), label=(batch, DS2_LABEL))
    return dict(zip(sym.list_arguments(), arg)), \
        dict(zip(sym.list_auxiliary_states(), aux))


def ds2_fit(pkg, train, ctx, arg_params, aux_params, num_epoch, metric,
            seed=0, batch_end_callback=None):
    """BucketingModule.fit of the model over ``train`` on ``ctx`` (the
    fused step, one graph a bucket, unless MXTPU_MODULE_FUSED=0): Adam at
    DS2_LR with deepspeech.cfg's gradient clip, from the given weights
    ({name: numpy})."""
    np.random.seed(seed)
    pkg.random.seed(seed)
    train.reset()                   # its batch order from the seed
    mod = pkg.mod.BucketingModule(ds2_sym_gen(pkg),
                                  default_bucket_key=train.default_bucket_key,
                                  context=ctx)
    mod.fit(train, eval_metric=metric, optimizer="adam",
            optimizer_params={"learning_rate": DS2_LR,
                              "clip_gradient": DS2_CLIP},
            num_epoch=num_epoch, arg_params=host_params(pkg, arg_params),
            aux_params=host_params(pkg, aux_params),
            batch_end_callback=batch_end_callback)
    return mod


class StepClock:
    """A fit's batch_end_callback: each step's host ms (fit's loop body,
    from one step's end to the next's, the card synchronized at each) by
    bucket, those of each bucket's first ``skip`` steps (its real step
    and, fused, its capture) apart from the rest. The fit's first step
    has no start to time from."""

    def __init__(self, skip):
        self.skip = skip
        self.last = None
        self.seen = {}
        self.first = {}             # bucket: [ms of its first steps]
        self.ms = {}                # bucket: [ms of its later steps]

    def __call__(self, param):
        import torch
        torch.cuda.synchronize()
        now = time.perf_counter()
        key = param.locals["batch"].bucket_key
        seen = self.seen[key] = self.seen.get(key, 0) + 1
        if self.last is not None:
            into = self.ms if seen > self.skip else self.first
            into.setdefault(key, []).append((now - self.last) * 1e3)
        self.last = now


def ds2_step_work(batch, bucket):
    """(FLOPs, bytes) a training step must do at least: forward and the
    backward's two products a multiply-add (3 x 2 x MACs) of the
    convolutions, the GRU's input and recurrent products and the output
    layer; each weight read, its gradient written and read and Adam's
    two states read and written, and the weight written, in float32. The
    backward's recompute of the time loop is not counted."""
    bins, hidden, layers, classes = ds2_widths()
    macs, weights = 0, 0
    c_in, t, f = 1, bucket, bins
    for channels, (kt, kf), (st, sf), (pt, pf) in DS2_CONV:
        t = (t + 2 * pt - kt) // st + 1
        f = (f + 2 * pf - kf) // sf + 1
        w = channels * c_in * kt * kf
        macs += batch * t * f * w
        weights += w
        c_in = channels
    feat, tokens = c_in * f, batch * t
    for layer in range(layers):
        w = 2 * 3 * hidden * (feat + hidden)
        macs += tokens * w
        weights += w
        feat = 2 * hidden
    macs += tokens * feat * classes
    weights += feat * classes
    return 6.0 * macs, 8.0 * 4 * weights


def ds2_cpu_check(mt, w, card):
    """The first step at DS2_CHECK_BATCH, bucket 200, on the card and on
    the CPU from the weights ``w`` (TF32 off): the loss within
    DS2_LOSS_RTOL and every gradient within DS2_GRAD_SHARE of its largest
    entry. Returns the text."""
    import torch
    bucket, batch = DS2["buckets"][0], DS2_CHECK_BATCH
    feats, labels = ds2_utterances(batch, 11, bucket)
    it = speech_iter(mt, feats, labels, batch, (bucket,), DS2["bins"],
                     DS2_LABEL)
    b = it.next()
    _, auxs = ds2_shapes(mt, bucket, batch)
    got = []
    for ctx in (mt.gpu(0), mt.cpu()):
        with ctx:
            ex = ds2_symbol(mt, bucket).simple_bind(
                ctx=ctx, grad_req="write", data=(batch, bucket, DS2["bins"]),
                label=(batch, DS2_LABEL))
            for k, v in w.items():
                ex.arg_dict[k][:] = v
            for k in auxs:
                ex.aux_dict[k][:] = np.ones(auxs[k], np.float32) \
                    if k.endswith("var") else np.zeros(auxs[k], np.float32)
            loss = ex.forward(is_train=True, data=b.data[0],
                              label=b.label[0])[0].asnumpy()
            ex.backward()
            got.append((float(loss.mean()), {
                k: g.asnumpy() for k, g in ex.grad_dict.items()
                if k in w}))
            del ex
    torch.cuda.empty_cache()
    (lg, gg), (lc, gc_) = got
    if not abs(lg - lc) <= DS2_LOSS_RTOL * abs(lc):
        fail("DeepSpeech 2 first step: loss %.6f on the card, %.6f on the "
             "CPU (limit %g relative)" % (lg, lc, DS2_LOSS_RTOL))
    worst, at = 0.0, None
    for k, want in gc_.items():
        err = float(np.abs(gg[k] - want).max()) / max(
            float(np.abs(want).max()), 1e-30)
        if err > worst:
            worst, at = err, k
        if not err <= DS2_GRAD_SHARE:
            fail("DeepSpeech 2 first step: %s's gradient on the card lies "
                 "%.3g of its largest entry from the CPU's (limit %g)"
                 % (k, err, DS2_GRAD_SHARE))
    return ("first step at batch %d, bucket %d on the card against the CPU "
            "(TF32 off): loss %.6f / %.6f; %d gradients, the worst %s at "
            "%.3g of its largest entry (limits %g relative, %g) | %s"
            % (batch, bucket, lg, lc, len(gc_), at, worst, DS2_LOSS_RTOL,
               DS2_GRAD_SHARE, card))


def ds2_first_steps(mt, w, auxs, card):
    """FIT_STEPS steps in bucket 200 from the same weights, captured and
    eager on the card: each step's CTC loss within DS2_STEP_RTOL."""
    bucket = DS2["buckets"][0]
    feats, labels = ds2_utterances(FIT_STEPS * DS2["batch"], 21, bucket)
    losses = {}
    for fused in (True, False):
        it = speech_iter(mt, feats, labels, DS2["batch"], (bucket,),
                         DS2["bins"], DS2_LABEL)
        metric = ctc_loss_metric(mt)
        mod = with_fused(fused, ds2_fit, mt, it, mt.gpu(0), w, auxs, 1,
                         metric)
        if fused:
            report = bucket_graph_report(mt, mod)
            if [r[3] for r in report.values()] != [FIT_STEPS - 1]:
                fail("DeepSpeech 2 first steps: %s (want one graph, %d "
                     "replays)" % (report, FIT_STEPS - 1))
        losses[fused] = metric.values
        del mod
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses[True],
                                                      losses[False]))
    if len(losses[True]) != FIT_STEPS or not worst <= DS2_STEP_RTOL:
        fail("DeepSpeech 2 first %d steps captured %s against eager %s "
             "(limit %g relative)" % (FIT_STEPS, losses[True], losses[False],
                                      DS2_STEP_RTOL))
    return ("first %d steps in bucket %d, captured against eager from the "
            "same weights: CTC losses %s / %s, worst %.3g relative (limit "
            "%g) | %s" % (FIT_STEPS, bucket, ", ".join(
                "%.4f" % v for v in losses[True]), ", ".join(
                "%.4f" % v for v in losses[False]), worst, DS2_STEP_RTOL,
                card))


def ctc_times(dev, card):
    """ctc_loss forward + backward at DeepSpeech 2's bucket-200 shape (T =
    100, N = 12, C = 29) beside torch.nn.functional.ctc_loss on the same
    inputs (log_softmax applied first: the port's op takes activations)
    as a yardstick. Returns (ms, F.ctc_loss ms, max |loss difference|)."""
    import torch
    import torch.nn.functional as F
    from mxtpu_torch.ops.nn import ctc_loss
    T, N, C = ds2_frames(DS2["buckets"][0]), DS2["batch"], DS2["classes"]
    rng = np.random.RandomState(5)
    x = torch.tensor(rng.randn(T, N, C).astype(np.float32), device=dev,
                     requires_grad=True)
    lens = np.minimum(rng.randint(T // 6, T // 4 + 1, N), DS2_LABEL)
    lab = np.zeros((N, DS2_LABEL), np.float32)
    for i, n in enumerate(lens):
        lab[i, :n] = rng.randint(1, C, n)
    label = torch.tensor(lab, device=dev)
    tgt = torch.tensor(lab, device=dev).long()
    tl = torch.tensor(lens, device=dev)
    il = torch.full((N,), T, dtype=torch.long, device=dev)

    def ours():
        ctc_loss(x, label).sum().backward()

    def library():
        F.ctc_loss(torch.log_softmax(x, 2), tgt, il, tl,
                   reduction="sum").backward()
    with torch.no_grad():
        diff = float((ctc_loss(x, label) - F.ctc_loss(
            torch.log_softmax(x, 2), tgt, il, tl,
            reduction="none")).abs().max())
    ms, lib_ms = cuda_ms(ours, iters=10, warmup=2), cuda_ms(library,
                                                            iters=10)
    print("ctc_loss forward + backward at (T=%d, N=%d, C=%d) on the card: "
          "%.3f ms (events over 10 calls; about %d small launches a call: "
          "torch ops on (N, S) tensors a step, S = %d); F.ctc_loss %.3f ms "
          "(a yardstick: it takes log-probabilities and returns inf for an "
          "impossible alignment); max |loss difference| %.3g | %s"
          % (T, N, C, ms, 30 * T, 2 * DS2_LABEL + 1, lib_ms, diff, card),
          flush=True)
    return ms, lib_ms, diff


def ds2_kernel_times(rnn_scan, rng, dev, card):
    """gru_scan at (T=100, N=12, H=1760) (the bucket-200 launch) against
    gru_scan_reference, its plan, card ms, bound and plain ms, and cuDNN
    torch.nn.GRU's ms on the same shape, one direction and both. Returns
    {"ms", "plain_ms", "bound_ms", "bound_by", "library_ms" (one
    direction), "library_bidir_ms", "max_abs_err", "plan"}."""
    import torch
    T, N, H = ds2_frames(DS2["buckets"][0]), DS2["batch"], DS2["hidden"]
    a = gru_args(rng, N, torch.float32, dev, T=T, H=H)
    got = rnn_scan.gru_scan(*a)
    want = rnn_scan.gru_scan_reference(*a)
    check_close("gru_scan T=%d N=%d H=%d f32" % (T, N, H), got, want,
                F32_TOL)
    err = max_err(got, want)
    plan = rnn_scan.scan_plan("gru", T, N, H, torch.float32, torch.float32)
    ms = cuda_ms(lambda: rnn_scan.gru_scan(*a), iters=10, warmup=2)
    plain_ms = cuda_ms(lambda: rnn_scan.gru_scan_reference(*a), iters=3,
                       warmup=1)
    bound_ms, bound_by = bound("gru", N, T=T, H=H)
    xs = torch.randn(T, N, H, device=dev)
    lib = {}
    for bidirectional in (False, True):
        gru = torch.nn.GRU(H, H, bidirectional=bidirectional).to(dev)
        with torch.no_grad():
            lib[bidirectional] = cuda_ms(lambda: gru(xs), iters=10,
                                         warmup=2)
    print("gru_scan at DeepSpeech 2's width T=%d N=%d H=%d f32 (%s mode, "
          "clusters of %d x %d rows): max |kernel - plain| %.3g (tolerance "
          "%s); kernel %.3f ms a launch (events over 10), plain %.3f ms, "
          "bound %.4f ms (%s; Wh alone, 3 x H^2 x 4 B = %.1f MB, read from "
          "HBM at every step would take %.3f ms), %.1f%% of the bound; "
          "cuDNN torch.nn.GRU (its input product included) one direction "
          "%.3f ms, bidirectional %.3f ms | %s"
          % (T, N, H, plan.mode, plan.cluster, plan.rows, err, F32_TOL, ms,
             plain_ms, bound_ms, bound_by, 3 * H * H * 4 / 1e6,
             T * 3 * H * H * 4 / PEAK_BYTES_S * 1e3, 100 * bound_ms / ms,
             lib[False], lib[True], card), flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib[False],
            "library_bidir_ms": lib[True], "max_abs_err": err,
            "plan": "%s, clusters of %d x %d rows" % (plan.mode, plan.cluster,
                                                     plan.rows)}


def ds2_phase(mt, rnn_scan, rng, dev, card):
    """Phase 31: DeepSpeech 2 at its published widths through
    BucketingModule.fit on gpu(0), TF32 off: the first step against the
    CPU, the first captured steps against eager ones, then a captured fit
    (gru_scan counted from 0 just before it: 6 launches a forward, 6
    nodes in each bucket's graph) and an eager one, each bucket's steps
    timed beside the step's bound, the card's busy share, the graphs and
    the peak memory; ctc_loss and gru_scan at the model's shapes. Returns
    (the fit's gru_scan launches, the kernel's timing)."""
    import torch
    clock = [("start", time.perf_counter())]
    kernel = ds2_kernel_times(rnn_scan, rng, dev, card)
    ctc = ctc_times(dev, card)
    clock.append(("kernels", time.perf_counter()))
    args, auxs = ds2_shapes(mt, DS2["buckets"][-1], DS2["batch"])
    w = ds2_init(args, 0)
    print("DeepSpeech 2 %s" % ds2_cpu_check(mt, w, card), flush=True)
    clock.append(("CPU check", time.perf_counter()))
    aux0 = {k: (np.ones if k.endswith("var") else np.zeros)(
        s, np.float32) for k, s in auxs.items()}
    print("DeepSpeech 2: %.1fM weights (float32), %s" % (
        sum(v.size for v in w.values()) / 1e6,
        ds2_first_steps(mt, w, aux0, card)), flush=True)
    clock.append(("first steps", time.perf_counter()))
    launches, out = {}, {}
    for path in ("captured", "eager"):
        feats, labels = ds2_data(31, DS2_UTTERANCES if path == "captured"
                                 else DS2_EAGER_UTTERANCES)
        it = speech_iter(mt, feats, labels, DS2["batch"], DS2["buckets"],
                         DS2["bins"], DS2_LABEL)
        metric = ctc_loss_metric(mt)
        clock_ = StepClock(2 if path == "captured" else 1)
        torch.cuda.reset_peak_memory_stats()
        rnn_scan.reset_launches()
        t0 = time.perf_counter()
        epochs = DS2_CAPTURED_EPOCHS if path == "captured" else 1
        mod = with_fused(path == "captured", ds2_fit, mt, it, mt.gpu(0), w,
                         aux0, epochs, metric, batch_end_callback=clock_)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        steps = epochs * len(it._plan)
        text = "eager"
        if path == "captured":
            report = bucket_graph_report(mt, mod)
            got = dict(rnn_scan.LAUNCHES)
            got["gru_scan"] += sum(r[2]["gru"] * r[3]
                                   for r in report.values())
            if any(r[2]["gru"] != 2 * DS2["layers"] for r in
                   report.values()) or \
                    got["gru_scan"] != 2 * DS2["layers"] * steps:
                fail("DeepSpeech 2 captured fit: graphs by bucket %s, "
                     "gru_scan launches %d in %d steps (want %d nodes a "
                     "graph, %d a step)" % (report, got["gru_scan"], steps,
                                            2 * DS2["layers"],
                                            2 * DS2["layers"]))
            text = ("captured: graphs by bucket (kernel nodes, other nodes, "
                    "time-loop nodes, replays, pool bytes) %s; ms of each "
                    "bucket's timed first steps (the real step where timed, "
                    "then the capture's) %s" % (report, ", ".join(
                        "%d: %s" % (b, " / ".join("%.1f" % v for v in ms))
                        for b, ms in sorted(clock_.first.items()))))
            launches = got
            losses = metric.values
            first, last = np.mean(losses[:4]), np.mean(losses[-4:])
            if not (np.isfinite(losses).all() and last < DS2_FALL * first):
                fail("DeepSpeech 2 captured fit: CTC loss of the first 4 "
                     "steps %.4f, the last 4 %.4f (want below %.2f of it)"
                     % (first, last, DS2_FALL))
            text += "; CTC loss first 4 steps %.4f, last 4 %.4f (limit " \
                "%.2f x)" % (first, last, DS2_FALL)
        elif rnn_scan.LAUNCHES["gru_scan"] != 2 * DS2["layers"] * steps:
            fail("DeepSpeech 2 eager fit: %d gru_scan launches in %d steps"
                 % (rnn_scan.LAUNCHES["gru_scan"], steps))
        print("DeepSpeech 2 BucketingModule.fit %s on gpu(0): %d epoch(s), "
              "%d steps in %.2f s (a bucket's first steps included: its "
              "real step and, captured, its capture); %s; peak memory "
              "%.2f GB | %s" % (path, epochs, steps, secs, text,
                                torch.cuda.max_memory_allocated() / 1e9,
                                card), flush=True)
        clock.append(("%s fit" % path, time.perf_counter()))
        # ms a step by bucket: the fit's own steps past each bucket's first
        # two, beside the step's bound
        for b, v in sorted(clock_.ms.items()):
            flops, nbytes = ds2_step_work(DS2["batch"], b)
            bound_at = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S) \
                * 1e3
            out[path, b] = float(np.median(v))
            print("DeepSpeech 2 %s step, bucket %d (%d frames after the "
                  "convolutions): %.3f ms (median of %d steps of the fit, "
                  "host clock: %s); bound %.3f ms (%.4g FLOPs at the "
                  "float32 rate, %.4g bytes), %.1f%% of it | %s"
                  % (path, b, ds2_frames(b), out[path, b], len(v), ", ".join(
                      "%.2f" % x for x in v), bound_at, flops, nbytes,
                     100 * bound_at / out[path, b], card), flush=True)
        if path == "captured":
            # the card's busy share: the kernel time of one replay of the
            # first bucket's graph (torch.profiler; tracing the larger
            # bucket's too cost about 6 s of host time) against that
            # replay's span (events), beside the fit's unprofiled step
            marks = [torch.cuda.Event(enable_timing=True), \
                     torch.cuda.Event(enable_timing=True)]
            for b in sorted(report)[:1]:
                graph = mod._buckets[b]._fused._cache.entries()[0].graph

                def replay():
                    marks[0].record()
                    graph.replay()
                    marks[1].record()
                busy, top = device_time(replay, 1)
                span = marks[0].elapsed_time(marks[1])
                print("DeepSpeech 2 captured step, bucket %d, on the card "
                      "(profiler, one replay of its graph): %s; the "
                      "unprofiled step %.3f ms; per step: %s | %s"
                      % (b, busy_of(busy, span), out[path, b], top, card),
                      flush=True)
            clock.append(("profile", time.perf_counter()))
        del mod
    torch.cuda.empty_cache()
    print("DeepSpeech 2 phase: %.1f s (%s)" % (
        clock[-1][1] - clock[0][1], ", ".join(
            "%s %.1f" % (name, t - clock[i][1])
            for i, (name, t) in enumerate(clock[1:]))), flush=True)
    return launches.get("gru_scan", 0), dict(kernel, ctc_ms=ctc[0],
                                             ctc_library_ms=ctc[1])


# ---------------------------------------------------------------------------
# Phase 32: the Gluon cells (gluon.rnn's LSTMCell / GRUCell stacks) against
# the fused layers at the word LM's PTB widths (GL_LM_PTB), and
# gluon.contrib's cells on the card
# ---------------------------------------------------------------------------

# the cell stack against the fused layer on the card (TF32 off): outputs,
# the loss and every gradient within GL_CELL_SHARE of the array's largest
# entry (the kernel and the cells' FullyConnected products sum in another
# order); then GL_CELL_STEPS SGD steps each way from the same weights,
# each step's loss within GL_CELL_SHARE relative and the weights within it
# of their largest; GL_CELL_TIMED steps each timed
GL_CELL_SHARE, GL_CELL_STEPS, GL_CELL_TIMED = 1e-4, 3, 5
GL_CELL_LR = 0.5
CONV_LSTM_STEPS = 30


def gl_cell_model(pkg, mode, fused, vocab, embed, hidden, layers):
    """The word LM's model (embedding, a recurrent stack, a Dense decoder)
    whose stack is the fused layer or a SequentialRNNCell of ``layers``
    cells, the i-th cell under the prefix "l<i>_" of the stack's "rnn_":
    their weights have the fused layer's names."""
    gluon = pkg.gluon
    r = gluon.rnn

    class CellLM(gluon.Block):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.embedding = gluon.nn.Embedding(vocab, embed)
                if fused:
                    self.rnn = (r.LSTM if mode == "lstm" else r.GRU)(
                        hidden, num_layers=layers, input_size=embed,
                        prefix="rnn_")
                else:
                    self.rnn = r.SequentialRNNCell(prefix="rnn_")
                    with self.rnn.name_scope():
                        for i in range(layers):
                            self.rnn.add((r.LSTMCell if mode == "lstm"
                                          else r.GRUCell)(
                                hidden, input_size=embed if i == 0
                                else hidden, prefix="l%d_" % i))
                self.decoder = gluon.nn.Dense(vocab, flatten=False,
                                              in_units=hidden)

        def forward(self, x):
            e = self.embedding(x)
            if fused:
                h = self.rnn(e)
            else:
                h, _ = self.rnn.unroll(x.shape[0], e, layout="TNC",
                                       merge_outputs=True)
            return self.decoder(h)
    return CellLM(prefix="celllm0_")


def gl_cell_runs(mt, rnn_scan, mode, w0, data, card):
    """The fused model and the hybridized cell stack from ``w0`` on
    gpu(0): one forward / backward held against each other, then
    GL_CELL_STEPS SGD steps each and GL_CELL_TIMED timed. Returns
    (text, the fused model's time-loop launches)."""
    import torch
    vocab, embed, hidden, layers, bptt, batch = GL_LM_PTB
    gpu = mt.gpu(0)
    x = mt.nd.array(data[:bptt].astype("f"), ctx=gpu)
    t = mt.nd.array(data[1:bptt + 1].astype("f"), ctx=gpu)
    ce = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    got, steps, ms, models = {}, {}, {}, {}
    launches = 0
    for fused in (True, False):
        model = gluon_load(mt, gl_cell_model(mt, mode, fused, vocab, embed,
                                             hidden, layers), w0, gpu)
        if not fused:
            model.rnn.hybridize()
        models[fused] = model
        rnn_scan.reset_launches()
        with mt.autograd.record():
            out = model(x)
            loss = ce(out.reshape((-3, 0)), t.reshape((-1,))).sum()
        loss.backward()
        got[fused] = dict({"loss": loss.asnumpy(), "out": out.asnumpy()},
                          **{k: p.grad().asnumpy() for k, p in
                             model.collect_params().items()})
        trainer = mt.gluon.Trainer(model.collect_params(), "sgd",
                                   {"learning_rate": GL_CELL_LR})
        losses = []
        for i in range(GL_CELL_STEPS + GL_CELL_TIMED):
            if i == GL_CELL_STEPS:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            with mt.autograd.record():
                loss = ce(model(x).reshape((-3, 0)), t.reshape((-1,))).mean()
            loss.backward()
            trainer.step(1)
            if i < GL_CELL_STEPS:
                losses.append(float(loss.asscalar()))
        torch.cuda.synchronize()
        ms[fused] = (time.perf_counter() - t0) / GL_CELL_TIMED * 1e3
        steps[fused] = (losses, gluon_values(model))
        if fused:
            launches = rnn_scan.LAUNCHES[mode + "_scan"]
            want = layers * (1 + GL_CELL_STEPS + GL_CELL_TIMED)
            if launches != want:
                fail("Gluon %s layer: %d %s_scan launches in %d forwards "
                     "(want %d)" % (mode, launches, mode,
                                    1 + GL_CELL_STEPS + GL_CELL_TIMED, want))
    worst = {}
    for what, (a, b) in (("forward and gradients", (got[True], got[False])),
                         ("weights after the steps", (steps[True][1],
                                                      steps[False][1]))):
        if sorted(a) != sorted(b):
            fail("Gluon %s cells: names %s against the layer's %s"
                 % (mode, sorted(b), sorted(a)))
        worst[what] = max(
            float(np.abs(a[k] - b[k]).max()) / max(float(np.abs(a[k]).max()),
                                                   1e-30) for k in a)
        if not worst[what] <= GL_CELL_SHARE:
            fail("Gluon %s cell stack against the fused layer on the card: "
                 "%s apart by %.3g of the largest entry (limit %g)"
                 % (mode, what, worst[what], GL_CELL_SHARE))
    apart = max(abs(a - b) / abs(a) for a, b in zip(steps[True][0],
                                                      steps[False][0]))
    if not apart <= GL_CELL_SHARE:
        fail("Gluon %s cells: step losses %s against the layer's %s"
             % (mode, steps[False][0], steps[True][0]))
    stats = list(models[False].rnn._children.values())[0].cache_stats()
    return ("Gluon %s at PTB's widths (vocab %d, embed %d, hidden %d, %d "
            "layers, bptt %d, batch %d) on gpu(0): a hybridized "
            "SequentialRNNCell of %d %sCells given the fused layer's weights "
            "against the layer: %s within %.3g, weights after %d SGD steps "
            "within %.3g of their largest, step losses within %.3g (limit "
            "%g); ms a step: the fused layer %.3f (%s_scan %d launches, one "
            "a layer a forward), the cell stack %.3f (its first cell's "
            "programs: %s) | %s"
            % (mode.upper(), vocab, embed, hidden, layers, bptt, batch, layers,
               mode.upper(), "outputs, loss and gradients",
               worst["forward and gradients"], GL_CELL_STEPS,
               worst["weights after the steps"], apart, GL_CELL_SHARE,
               ms[True], mode, launches, ms[False], stats, card)), launches


def conv_lstm_learns(pkg, ctx, steps=CONV_LSTM_STEPS):
    """tests/test_gluon_contrib.py's ConvLSTM check on ``ctx``: a
    Conv2DLSTMCell and a 1x1 head learn to predict a frame, Adam, the
    loss of the last step below the first's. Returns the losses."""
    pkg.random.seed(0)
    cr, nn = pkg.gluon.contrib.rnn, pkg.gluon.nn
    cell = cr.Conv2DLSTMCell(input_shape=(1, 6, 6), hidden_channels=4,
                             i2h_kernel=3, h2h_kernel=3, i2h_pad=1)
    head = nn.Conv2D(1, 1)
    cell.initialize(pkg.init.Xavier(), ctx=ctx)
    head.initialize(pkg.init.Xavier(), ctx=ctx)
    params = dict(cell.collect_params())
    params.update(head.collect_params())
    trainer = pkg.gluon.Trainer(params, "adam", {"learning_rate": 1e-2})
    rng = np.random.RandomState(0)
    seq = [pkg.nd.array(rng.rand(2, 1, 6, 6).astype(np.float32), ctx=ctx)
           for _ in range(4)]
    loss_fn = pkg.gluon.loss.L2Loss()
    losses = []
    for _ in range(steps):
        with pkg.autograd.record():
            outs, _ = cell.unroll(4, seq, merge_outputs=False)
            loss = loss_fn(head(outs[-2]), seq[-1])
        loss.backward()
        trainer.step(2)
        losses.append(float(loss.mean().asscalar()))
    if not losses[-1] < losses[0]:
        fail("Conv2DLSTMCell on %s: loss %.5f -> %.5f, not falling"
             % (ctx, losses[0], losses[-1]))
    return losses


def lstmp_unroll(mt, ctx, w):
    """LSTMPCell(hidden 16, projection 8) unrolled 5 steps on ``ctx`` from
    weights ``w`` (None: drawn, then returned): (outputs and states as
    numpy, weights)."""
    cell = mt.gluon.contrib.rnn.LSTMPCell(16, 8, input_size=12,
                                          prefix="lstmp0_")
    cell.initialize(mt.init.Xavier(), ctx=ctx)
    if w is not None:
        cell.collect_params().load_dict(w, ctx=ctx)
    x = mt.nd.array(np.random.RandomState(3).randn(4, 5, 12).astype("f"),
                    ctx=ctx)
    outs, states = cell.unroll(5, x, layout="NTC", merge_outputs=True)
    return [outs.asnumpy()] + [s.asnumpy() for s in states], \
        {k: p.data().asnumpy() for k, p in cell.collect_params().items()}


def gluon_cells_phase(mt, rnn_scan, seed, card):
    """Phase 32: the LSTM and GRU cell stacks against the fused layers at
    PTB's widths (B4 and B5 in the layers), a Conv2DLSTMCell learning and
    an LSTMPCell unrolled on gpu(0) against the CPU. Returns {kernel:
    launches} of the fused layers."""
    t0 = time.time()
    vocab, embed, hidden, layers, bptt, batch = GL_LM_PTB
    rng = np.random.RandomState(seed + 5)
    data = lm_batchify(markov_corpus(bptt * batch * 2, vocab, rng), batch)
    launches = {}
    for mode in ("lstm", "gru"):
        w0 = gluon_weights(mt, gl_cell_model(mt, mode, True, vocab, embed,
                                             hidden, layers), seed,
                           data[:bptt].astype("f"), init=mt.init.Xavier())
        text, launches[mode + "_scan"] = gl_cell_runs(mt, rnn_scan, mode, w0,
                                                      data, card)
        print(text, flush=True)
    losses = conv_lstm_learns(mt, mt.gpu(0))
    card_out, w = lstmp_unroll(mt, mt.gpu(0), None)
    cpu_out, _ = lstmp_unroll(mt, mt.cpu(), w)
    worst = max(float(np.abs(a - b).max()) for a, b in zip(card_out,
                                                            cpu_out))
    if not worst <= F32_TOL["atol"]:
        fail("LSTMPCell on gpu(0): %.3g from the CPU's (limit %g)"
             % (worst, F32_TOL["atol"]))
    print("gluon.contrib on gpu(0): Conv2DLSTMCell's loss %.5f -> %.5f over "
          "%d Adam steps (falling, as tests/test_gluon_contrib.py asserts); "
          "LSTMPCell(16, projection 8) unrolled 5 steps: max |card - CPU| "
          "%.3g (limit %g); phase %.1f s | %s"
          % (losses[0], losses[-1], len(losses), worst, F32_TOL["atol"],
             time.time() - t0, card), flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 33: rematerialization. hybridize(remat=True) on the four residual
# stages of resnet18_v1 (BASELINE.json config 3: 224^2, batch 128, TF32
# off), the net around them not hybridized; MXNET_BACKWARD_DO_MIRROR=1 on
# LeNet's Module.fit (config 1), eager and captured
# ---------------------------------------------------------------------------

# REMAT_CHECKED steps each way under cuDNN's deterministic algorithms (the
# first runs for real, the second captures, the third replays): every
# gradient within REMAT_SHARE of its largest entry, the moving statistics
# and weights alike; then REMAT_TIMED steps each way for ms a step and the
# peak memory
REMAT_CHECKED, REMAT_TIMED, REMAT_SHARE = 3, 5, 1e-5


def remat_stages(net):
    """resnet18_v1's four residual stages (its features' HybridSequential
    children)."""
    stages = [c for c in net.features._children.values()
              if type(c).__name__ == "HybridSequential"]
    if len(stages) != 4:
        fail("resnet18_v1 has %d residual stages, want 4" % len(stages))
    return stages


def remat_run(mt, w0, x, y, remat, card):
    """resnet18_v1 from ``w0`` on gpu(0), its stages hybridized with
    ``remat``: REMAT_CHECKED steps (deterministic cuDNN) keeping every
    gradient, then REMAT_TIMED timed. Returns (gradients by step, the
    values after the checked steps, ms a step, the peak bytes allocated
    above what the card held at the start over the checked steps and over
    the timed ones, the bytes reserved, the stages' counts)."""
    import torch
    gpu = mt.gpu(0)
    net = gluon_load(mt, gluon_resnet18(mt), w0, gpu)
    for s in remat_stages(net):
        s.hybridize(remat=remat)
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd", dict(GL_OPT))
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    xs, ys = mt.nd.array(x, ctx=gpu), mt.nd.array(y, ctx=gpu)
    params = net.collect_params()
    grads = []
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    def step():
        with mt.autograd.record():
            loss = loss_fn(net(xs), ys)
        loss.backward()
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for _ in range(REMAT_CHECKED):
            step()
            grads.append({k: p.grad().asnumpy() for k, p in params.items()
                          if p.grad_req != "null"})
            trainer.step(x.shape[0])
    finally:
        torch.backends.cudnn.deterministic = old
    values = gluon_values(net)
    torch.cuda.synchronize()
    peak_checked = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(REMAT_TIMED):
        step()
        trainer.step(x.shape[0])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / REMAT_TIMED * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    reserved = torch.cuda.memory_reserved()
    stats = [s.cache_stats() for s in remat_stages(net)]
    captures = int(gpu.device_type == "gpu")
    if any(st["captures"] != captures or st["fallbacks"] or st["uncaptured"]
           for st in stats) or \
            any(p.remat != remat for s in remat_stages(net)
                for p in s.programs()):
        fail("resnet18_v1 stages (remat=%s): %s" % (remat, stats))
    del net, trainer
    return grads, values, ms, peak_checked, peak, reserved, stats


def lenet_mirror_fits(mt, card):
    """LeNet's Module.fit (one epoch, deterministic cuDNN) eager and
    captured, each with and without MXNET_BACKWARD_DO_MIRROR=1, from the
    same weights: the mirrored fit's weights equal the plain one's within
    CAPTURE_TOL (the captured fit's fused step ignores the mirror, which
    saves nothing inside one function). Returns the text."""
    import torch
    data = lenet_data()
    p0 = lenet_init_params(mt, 0)
    out = {}
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for path, kv in (("eager", None), ("captured", "local")):
            for mirror in ("0", "1"):
                np.random.seed(0)
                with env_set(MXNET_BACKWARD_DO_MIRROR=mirror):
                    mod = lenet_fit(mt, data, context=mt.gpu(0),
                                    arg_params=p0, num_epoch=1,
                                    validate=False, kvstore=kv)[0]
                execs = mod._exec_group.execs
                if any(e._mirror != (mirror == "1") for e in execs) or \
                        (path == "captured") != (mod._fused is not None):
                    fail("LeNet %s fit: mirror %s at bind, fused %s"
                         % (path, [e._mirror for e in execs], mod._fused))
                out[path, mirror] = module_params(mod)
    finally:
        torch.backends.cudnn.deterministic = old
    text = []
    for path in ("eager", "captured"):
        a, b = out[path, "0"], out[path, "1"]
        worst = max(float(np.abs(a[k] - b[k]).max()) for k in a)
        if not worst <= CAPTURE_TOL["atol"]:
            fail("LeNet %s fit with MXNET_BACKWARD_DO_MIRROR=1: weights %.3g "
                 "from the plain fit's (limit %g)"
                 % (path, worst, CAPTURE_TOL["atol"]))
        text.append("%s %.3g" % (path, worst))
    return ("LeNet Module.fit, one epoch from the same weights with "
            "MXNET_BACKWARD_DO_MIRROR=1 against without (deterministic "
            "cuDNN): max |weight difference| %s (limit %g) | %s"
            % (", ".join(text), CAPTURE_TOL["atol"], card))


def remat_phase(mt, seed, card):
    """Phase 33: resnet18_v1's stages with and without remat on gpu(0),
    TF32 off: the same gradients, moving statistics and weights, then ms
    a step and the peak memory both ways; the executor's mirror on
    LeNet."""
    import gc
    import torch
    t0 = time.time()
    x, y = gluon_images(seed + 7, GL_BATCH)
    w0 = gluon_weights(mt, gluon_resnet18(mt), seed, x[:2])
    runs = {}
    for remat in (False, True):
        gc.collect()                # what earlier phases left, freed
        torch.cuda.empty_cache()
        runs[remat] = remat_run(mt, w0, x, y, remat, card)
    (g0, v0, ms0, pc0, p0, r0, s0), (g1, v1, ms1, pc1, p1, r1, s1) = \
        runs[False], runs[True]
    worst = 0.0
    for step, (a, b) in enumerate(zip(g0 + [v0], g1 + [v1])):
        for k in a:
            err = float(np.abs(a[k] - b[k]).max()) / max(
                float(np.abs(a[k]).max()), 1e-30)
            worst = max(worst, err)
            if not err <= REMAT_SHARE:
                fail("resnet18_v1 with remat: %s %s %.3g of its largest entry "
                     "from the plain run's (limit %g)"
                     % ("after the steps" if step == len(g0) else
                        "step %d gradient" % (step + 1), k, err, REMAT_SHARE))
    print("resnet18_v1 (224^2, batch %d, TF32 off) with its 4 residual stages "
          "hybridized, remat=True against remat=False: %d steps' gradients, "
          "then the weights and moving statistics (blended once a step), "
          "within %.3g of their largest entries (limit %g, deterministic "
          "cuDNN); ms a step %.3f / %.3f (remat / plain, %d steps, host "
          "clock); peak memory allocated above the run's start %.3f / %.3f "
          "GB in the steady state, %.3f / %.3f GB over the first steps (the "
          "captures among them); reserved %.3f / %.3f GB; stages' programs "
          "(remat): %s | %s"
          % (GL_BATCH, REMAT_CHECKED, worst, REMAT_SHARE, ms1, ms0,
             REMAT_TIMED, p1 / 1e9, p0 / 1e9, pc1 / 1e9, pc0 / 1e9,
             r1 / 1e9, r0 / 1e9, s1[0], card), flush=True)
    if not p1 < p0:
        fail("resnet18_v1 with remat: peak memory %.3f GB, not below the "
             "plain run's %.3f GB" % (p1 / 1e9, p0 / 1e9))
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    print(lenet_mirror_fits(mt, card), flush=True)
    print("remat phase: %.1f s" % (time.time() - t0), flush=True)
    return {"remat": ms1, "plain": ms0}


# ---------------------------------------------------------------------------
# Phase 34: the Gluon examples no phase ran: lstm_crf.py, super_resolution.py,
# actor_critic.py, kaggle_k_fold_cross_validation.py and
# learning_rate_manipulation.py, each mirrored for either package with the
# context a parameter (the examples import mxtpu and use the default)
# ---------------------------------------------------------------------------

def lstm_crf_model(pkg):
    """lstm_crf.py's CRF and BiLSTMCRF for ``pkg``: vocabulary 6, embed 8,
    hidden 8, 3 tags."""
    gluon, nn, rnn = pkg.gluon, pkg.gluon.nn, pkg.gluon.rnn

    def log_sum_exp(v, axis=-1):
        m = v.max(axis=axis, keepdims=True)
        return (m + (v - m.broadcast_like(v)).exp()
                .sum(axis=axis, keepdims=True).log()).squeeze(axis=axis)

    class CRF(gluon.Block):
        def __init__(self, num_tags, **kw):
            super().__init__(**kw)
            self.n = num_tags
            with self.name_scope():
                self.trans = self.params.get(
                    "trans", shape=(num_tags + 2, num_tags + 2),
                    init=pkg.init.Uniform(0.1))

        def _partition(self, feats):
            trans = self.trans.data()
            alpha = feats[0] + trans.slice_axis(
                axis=0, begin=self.n, end=self.n + 1).reshape(
                (self.n + 2,))[:self.n]
            for t in range(1, feats.shape[0]):
                mat = alpha.reshape((self.n, 1)) + \
                    trans.slice(begin=(0, 0), end=(self.n, self.n))
                alpha = log_sum_exp(mat, axis=0) + feats[t]
            stop = trans.slice(begin=(0, self.n + 1),
                               end=(self.n, self.n + 2)).reshape((self.n,))
            return log_sum_exp(alpha + stop, axis=0)

        def neg_log_likelihood(self, feats, tags):
            trans = self.trans.data()
            gold = trans[self.n, tags[0]]
            for t in range(feats.shape[0]):
                gold = gold + feats[t, tags[t]]
                if t + 1 < feats.shape[0]:
                    gold = gold + trans[tags[t], tags[t + 1]]
            gold = gold + trans[tags[-1], self.n + 1]
            return self._partition(feats) - gold

        def viterbi(self, feats):
            trans = self.trans.data().asnumpy()
            f = feats.asnumpy()
            n = self.n
            delta = f[0] + trans[n, :n]
            back = []
            for t in range(1, f.shape[0]):
                mat = delta[:, None] + trans[:n, :n]
                back.append(mat.argmax(axis=0))
                delta = mat.max(axis=0) + f[t]
            delta = delta + trans[:n, n + 1]
            best = int(delta.argmax())
            path = [best]
            for bp in reversed(back):
                best = int(bp[best])
                path.append(best)
            return list(reversed(path))

    class BiLSTMCRF(gluon.Block):
        def __init__(self, vocab, embed, hidden, num_tags, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.embedding = nn.Embedding(vocab, embed)
                self.lstm = rnn.LSTM(hidden // 2, bidirectional=True)
                self.fc = nn.Dense(num_tags, flatten=False)
                self.crf = CRF(num_tags)

        def feats(self, sent):
            e = self.embedding(sent).expand_dims(1)
            h = self.lstm(e)
            return self.fc(h).reshape((sent.shape[0], -1))

        def neg_log_likelihood(self, sent, tags):
            return self.crf.neg_log_likelihood(self.feats(sent), tags)

        def predict(self, sent):
            return self.crf.viterbi(self.feats(sent))
    return BiLSTMCRF(6, 8, 8, 3, prefix="bilstmcrf0_")


def example_init(pkg, net, ctx, weights, sample):
    """``net`` on ``ctx``: Xavier as the example, its deferred shapes
    resolved by a call of ``sample``, then ``weights`` ({name: numpy})
    where given."""
    net.initialize(pkg.init.Xavier(), ctx=ctx)
    sample()
    if weights is not None:
        gluon_load(pkg, net, weights, ctx)
    return net


def lstm_crf_main(pkg, ctx, weights=None, steps=None):
    """lstm_crf.py's main on ``ctx``: 60 epochs of SGD over 4 tagged
    sentences, then Viterbi tagging; fails unless the tag accuracy is at
    least 0.9. With ``steps``: (the first steps' losses, the weights,
    the last step's gradients)."""
    vocab = {"the": 0, "a": 1, "dog": 2, "cat": 3, "runs": 4, "sat": 5}
    tagset = {"DET": 0, "NOUN": 1, "VERB": 2}
    data = [("the dog runs", "DET NOUN VERB"), ("a cat sat", "DET NOUN VERB"),
            ("the cat runs", "DET NOUN VERB"), ("a dog sat", "DET NOUN VERB")]

    def sentence(s):
        return pkg.nd.array([vocab[w] for w in s.split()], ctx=ctx)
    model = lstm_crf_model(pkg)
    example_init(pkg, model, ctx, weights, lambda: model.neg_log_likelihood(
        sentence(data[0][0]), [0, 1, 2]))
    trainer = pkg.gluon.Trainer(model.collect_params(), "sgd",
                                {"learning_rate": 0.05, "momentum": 0.9})
    losses = []
    if steps == 0:
        return losses, gluon_values(model)
    for epoch in range(60):
        for sent, tags in data:
            t = [tagset[x] for x in tags.split()]
            with pkg.autograd.record():
                loss = model.neg_log_likelihood(sentence(sent), t)
            loss.backward()
            trainer.step(1)
            losses.append(float(loss.asnumpy()))
            if steps is not None and len(losses) == steps:
                return losses, gluon_values(model), gluon_grads(model)
    correct = total = 0
    for sent, tags in data:
        want = [tagset[x] for x in tags.split()]
        got = model.predict(sentence(sent))
        correct += sum(a == b for a, b in zip(got, want))
        total += len(want)
    if not correct / total >= 0.9:
        fail("lstm_crf on %s: tag accuracy %.2f (the example asserts at "
             "least 0.9)" % (ctx, correct / total))
    return "tag accuracy %.2f, nll %.4f -> %.4f" % (
        correct / total, np.mean(losses[:4]), np.mean(losses[-4:]))


def super_resolution_model(pkg, upscale=2):
    gluon, nn = pkg.gluon, pkg.gluon.nn

    class SuperRes(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.upscale = upscale
            with self.name_scope():
                self.conv1 = nn.Conv2D(16, 5, padding=2, activation="relu")
                self.conv2 = nn.Conv2D(16, 3, padding=1, activation="relu")
                self.conv3 = nn.Conv2D(upscale ** 2, 3, padding=1)

        def hybrid_forward(self, F, x):
            h = self.conv3(self.conv2(self.conv1(x)))
            h = F.reshape(h, shape=(0, -4, self.upscale, self.upscale, 0, 0))
            h = F.transpose(h, axes=(0, 3, 1, 4, 2))
            h = F.reshape(h, shape=(0, -3, -3))
            return F.expand_dims(h, axis=1)
    return SuperRes(prefix="superres0_")


def super_resolution_images(n, hw, rng):
    """super_resolution.py's make_images: sums of low-frequency waves."""
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32) / hw
    imgs = np.zeros((n, 1, hw, hw), np.float32)
    for i in range(n):
        for _ in range(4):
            fx, fy = rng.uniform(1, 4, 2)
            ph = rng.uniform(0, 2 * np.pi)
            imgs[i, 0] += np.sin(2 * np.pi * (fx * xx + fy * yy) + ph)
        imgs[i] = (imgs[i] - imgs[i].min()) / np.ptp(imgs[i])
    return imgs


def psnr(a, b):
    return 10 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-12))


def super_resolution_main(pkg, ctx, weights=None, steps=None):
    """super_resolution.py's main on ``ctx``: ESPCN, hybridized, 30 epochs
    of Adam under L2 over 64 synthetic images; fails unless the model's
    PSNR beats nearest-neighbour upscaling. With ``steps``: (the first
    steps' losses, the weights, the last step's gradients)."""
    np.random.seed(0)
    rng = np.random.RandomState(0)
    hi = super_resolution_images(64, 32, rng)
    lo = hi[:, :, ::2, ::2]
    net = super_resolution_model(pkg)
    example_init(pkg, net, ctx, weights,
                 lambda: net(pkg.nd.array(lo[:1], ctx=ctx)))
    net.hybridize()
    trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 0.005})
    l2 = pkg.gluon.loss.L2Loss()
    it = pkg.io.NDArrayIter(lo, hi, batch_size=16, shuffle=True)
    losses = []
    if steps == 0:
        return losses, gluon_values(net)
    for epoch in range(30):
        it.reset()
        for b in it:
            x, y = b.data[0].as_in_context(ctx), b.label[0].as_in_context(ctx)
            with pkg.autograd.record():
                loss = l2(net(x), y)
            loss.backward()
            trainer.step(x.shape[0])
            losses.append(float(loss.mean().asnumpy()))
            if steps is not None and len(losses) == steps:
                return losses, gluon_values(net), gluon_grads(net)
    out = net(pkg.nd.array(lo[:8], ctx=ctx)).asnumpy()
    model_psnr = psnr(out, hi[:8])
    base_psnr = psnr(np.repeat(np.repeat(lo[:8], 2, 2), 2, 3), hi[:8])
    if not model_psnr > base_psnr:
        fail("super_resolution on %s: PSNR %.2f dB, nearest %.2f dB (the "
             "example asserts above)" % (ctx, model_psnr, base_psnr))
    return "PSNR %.2f dB against nearest %.2f dB" % (model_psnr, base_psnr)


def actor_critic_model(pkg):
    gluon, nn = pkg.gluon, pkg.gluon.nn

    class Net(gluon.Block):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.dense = nn.Dense(16, activation="relu")
                self.action = nn.Dense(2)
                self.value = nn.Dense(1)

        def forward(self, x):
            h = self.dense(x)
            return self.action(h), self.value(h)
    return Net(prefix="net0_")


def actor_critic_main(pkg, ctx, weights=None, steps=None, n_states=8,
                      gamma=0.95):
    """actor_critic.py's main on ``ctx``: 150 episodes of the 8-state
    chain walk, Adam on the advantage-weighted log-probabilities plus the
    value's squared error; fails unless the late episodes are no longer
    than the early ones and shorter than 12 moves. With ``steps``: (the
    first episodes' losses, the weights, the last episode's gradients)."""
    def one_hot(s):
        v = np.zeros((1, n_states), np.float32)
        v[0, s] = 1
        return pkg.nd.array(v, ctx=ctx)
    net = actor_critic_model(pkg)
    example_init(pkg, net, ctx, weights, lambda: net(one_hot(0)))
    trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 0.02})
    rng = np.random.RandomState(0)
    lengths, losses = [], []
    if steps == 0:
        return losses, gluon_values(net)
    for episode in range(150):
        with pkg.autograd.record():
            s, rewards, logps, values = 0, [], [], []
            for _ in range(40):
                logits, val = net(one_hot(s))
                p = np.asarray(pkg.nd.softmax(logits).asnumpy()).ravel()
                a = int(rng.rand() < p[1])
                logps.append(pkg.nd.log_softmax(logits)[0, a])
                s = max(0, s - 1) if a == 0 else min(n_states - 1, s + 1)
                rewards.append(1.0 if s == n_states - 1 else -0.01)
                values.append(val[0, 0])
                if s == n_states - 1:
                    break
            R, loss = 0.0, None
            for r, logp, v in zip(reversed(rewards), reversed(logps),
                                  reversed(values)):
                R = r + gamma * R
                adv = R - float(v.asnumpy())
                term = -logp * adv + (v - R) ** 2
                loss = term if loss is None else loss + term
        loss.backward()
        trainer.step(1)
        lengths.append(len(rewards))
        losses.append(float(loss.asnumpy()))
        if steps is not None and len(losses) == steps:
            return losses, gluon_values(net), gluon_grads(net)
    early, late = np.mean(lengths[:30]), np.mean(lengths[-30:])
    if not (late <= early and late < 12):
        fail("actor_critic on %s: episode length %.1f -> %.1f (the example "
             "asserts no longer, and below 12)" % (ctx, early, late))
    return "episode length %.1f -> %.1f moves" % (early, late)


def kfold_main(pkg, ctx, weights=None, steps=None, k_folds=5, epochs=25):
    """kaggle_k_fold_cross_validation.py's main on ``ctx``: 5 folds of an
    MLP under L2 with Adam (wd 0.1), 25 epochs each; fails unless the
    mean log-RMSE beats the constant prediction's. With ``steps``: fold
    0's first steps' losses, the weights and the last step's gradients."""
    np.random.seed(0)
    r = np.random.RandomState(7)
    n, d = 500, 16
    X = r.standard_normal((n, d)).astype("f")
    w = r.uniform(0.5, 2.0, d).astype("f")
    y = np.exp(0.2 * (X @ w)) * 100
    folds = np.array_split(np.arange(n), k_folds)
    scores, losses = [], []
    for k in range(k_folds):
        va = folds[k]
        tr = np.concatenate([folds[i] for i in range(k_folds) if i != k])
        net = pkg.gluon.nn.HybridSequential(prefix="kfold%d_" % k)
        with net.name_scope():
            net.add(pkg.gluon.nn.Dense(32, activation="relu"),
                    pkg.gluon.nn.Dense(1))
        net.initialize(pkg.init.Xavier(), force_reinit=True, ctx=ctx)
        if weights is not None or steps == 0:
            net(pkg.nd.array(X[:1], ctx=ctx))
        if weights is not None:
            gluon_load(pkg, net, weights, ctx)
        if steps == 0:
            return losses, gluon_values(net)
        loss_fn = pkg.gluon.loss.L2Loss()
        trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                    {"learning_rate": 0.01, "wd": 0.1})
        it = pkg.io.NDArrayIter(X[tr].astype("f"), y[tr].astype("f"),
                                batch_size=64, shuffle=True)
        for _ in range(epochs):
            it.reset()
            for b in it:
                x, t = b.data[0].as_in_context(ctx), \
                    b.label[0].as_in_context(ctx)
                with pkg.autograd.record():
                    loss = loss_fn(net(x).reshape((-1,)), t)
                loss.backward()
                trainer.step(x.shape[0])
                if steps is not None:
                    losses.append(float(loss.mean().asnumpy()))
                    if len(losses) == steps:
                        return losses, gluon_values(net), \
                            gluon_grads(net)
        preds = np.clip(net(pkg.nd.array(X[va], ctx=ctx)).asnumpy().ravel(),
                        1, None)
        scores.append(float(np.sqrt(np.mean((np.log(preds)
                                             - np.log(y[va])) ** 2))))
    baseline = float(np.sqrt(np.mean((np.log(y) - np.log(y.mean())) ** 2)))
    if not np.mean(scores) < baseline:
        fail("kaggle_k_fold on %s: log-RMSE %.4f, the constant's %.4f (the "
             "example asserts below)" % (ctx, np.mean(scores), baseline))
    return "mean log-RMSE %.4f over %d folds (the constant %.4f)" % (
        np.mean(scores), k_folds, baseline)


def lr_manipulation_main(pkg, ctx, weights=None, steps=None):
    """learning_rate_manipulation.py's main on ``ctx``: set_learning_rate
    between epochs, then a FactorScheduler; fails unless the rates are the
    example's. With ``steps``: the first steps' losses, the weights and
    the last step's gradients."""
    np.random.seed(0)
    r = np.random.RandomState(0)
    X = r.standard_normal((256, 8)).astype("f")
    y = (X @ r.standard_normal(8).astype("f")).astype("f")
    net = pkg.gluon.nn.Dense(1, prefix="dense0_")
    example_init(pkg, net, ctx, weights,
                 lambda: net(pkg.nd.array(X[:1], ctx=ctx)))
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
    l2 = pkg.gluon.loss.L2Loss()
    seen, losses = [], []
    if steps == 0:
        return losses, gluon_values(net)
    for epoch in range(6):
        if epoch == 3:
            trainer.set_learning_rate(trainer.learning_rate * 0.1)
        seen.append(trainer.learning_rate)
        for b in pkg.io.NDArrayIter(X, y, batch_size=32, shuffle=True):
            x, t = b.data[0].as_in_context(ctx), b.label[0].as_in_context(ctx)
            with pkg.autograd.record():
                loss = l2(net(x).reshape((-1,)), t)
            loss.backward()
            trainer.step(x.shape[0])
            losses.append(float(loss.mean().asnumpy()))
            if steps is not None and len(losses) == steps:
                return losses, gluon_values(net), gluon_grads(net)
    net2 = pkg.gluon.nn.Dense(1, prefix="dense1_")
    net2.initialize(pkg.init.Xavier(), ctx=ctx)
    trainer2 = pkg.gluon.Trainer(net2.collect_params(), "sgd", {
        "learning_rate": 0.2,
        "lr_scheduler": pkg.lr_scheduler.FactorScheduler(step=3,
                                                         factor=0.5)})
    lrs = []
    for b in pkg.io.NDArrayIter(X, y, batch_size=32):
        x, t = b.data[0].as_in_context(ctx), b.label[0].as_in_context(ctx)
        with pkg.autograd.record():
            loss = l2(net2(x).reshape((-1,)), t)
        loss.backward()
        trainer2.step(x.shape[0])
        lrs.append(trainer2.learning_rate)
    if not (seen[0] == 0.1 and abs(seen[-1] - 0.01) < 1e-9 and
            lrs[-1] < lrs[0]):
        fail("learning_rate_manipulation on %s: rates %s, scheduled %s"
             % (ctx, seen, lrs))
    return "rates by epoch %s, scheduled %.3f -> %.3f, loss %.5f -> %.5f" % (
        ", ".join("%g" % v for v in seen), lrs[0], lrs[-1], losses[0],
        losses[-1])


GLUON_EXAMPLES = (("lstm_crf", lstm_crf_main),
                  ("super_resolution", super_resolution_main),
                  ("actor_critic", actor_critic_main),
                  ("kaggle_k_fold_cross_validation", kfold_main),
                  ("learning_rate_manipulation", lr_manipulation_main))
# the examples trained with Adam, and their rates. Adam moves a weight by
# about lr whatever its gradient's size, so where a gradient is near 0 (a
# dead ReLU's input weights) a last-bit difference in it (cuDNN's sums
# against the CPU's) moves the weight by up to 2 lr either way:
# super_resolution's first conv weights ended 3 steps 0.0131 of their
# largest apart on the H100. So their step-1 gradients, taken before Adam,
# are held to the CPU's within EX_SHARE, and after FIT_STEPS steps every
# weight within EX_SHARE of its array's largest value but for at most
# GLUON_ADAM_APART entries of the example, each within 2 lr: three times
# the largest reading on the H100 (super_resolution 4 of 3,316 entries,
# the largest 0.246-0.395 lr apart; the other two none)
GLUON_ADAM_LR = {"super_resolution": 0.005, "actor_critic": 0.02,
                 "kaggle_k_fold_cross_validation": 0.01}
GLUON_ADAM_APART = 12


def gluon_examples_first(pkg, ctx, weights):
    """Each example's first FIT_STEPS steps on ``ctx`` from ``weights``
    ({example: {name: numpy}}): {example: (losses, weights after, the
    last step's gradients, step 1's gradients)}."""
    out = {}
    for ex, main in GLUON_EXAMPLES:
        pkg.random.seed(0)
        first = None
        if ex in GLUON_ADAM_LR:
            first = main(pkg, ctx, weights[ex], steps=1)[2]
            pkg.random.seed(0)
        out[ex] = main(pkg, ctx, weights[ex], steps=FIT_STEPS) + (first,)
    return out


def largest_share_apart(got, want):
    """The largest difference of any array of ``got`` from ``want`` as a
    share of that array's largest value in ``want``."""
    return max(float(np.abs(np.asarray(got[k]) - w).max()) /
               max(float(np.abs(w).max()), 1e-30) for k, w in want.items())


def hold_shares(label, checks):
    """``checks``: (what, got, want), ``got`` on the card and ``want`` on
    the CPU ({name: numpy} each), each within EX_SHARE of its arrays'
    largest values. Returns a text for each."""
    text = []
    for what, got, want in checks:
        err = largest_share_apart(got, want)
        if not err <= EX_SHARE:
            fail("%s: %s on gpu(0) (first %d steps) differ from the CPU's "
                 "by %.3g of their largest value (limit %g)"
                 % (label, what, FIT_STEPS, err, EX_SHARE))
        text.append("%s (%d arrays) within %.3g" % (what, len(want), err))
    return text


def adam_weights_apart(values, want):
    """Weights after Adam steps on two devices ({name: numpy} each): (the
    entries past EX_SHARE of their array's largest value, the largest
    difference, the entries). Adam's step is near lr for a tiny
    gradient whatever its size, so rounding can move such an entry by up
    to 2 lr: each model's limits come from its own reading."""
    apart, worst, entries = 0, 0.0, 0
    for k, w in want.items():
        d = np.abs(values[k] - w)
        apart += int((d > EX_SHARE * float(np.abs(w).max())).sum())
        worst = max(worst, float(d.max()))
        entries += w.size
    return apart, worst, entries


def hold_adam_steps(label, got, want, lr, max_apart, max_lr):
    """``got`` and ``want``: (losses, weights after FIT_STEPS Adam steps,
    step 1's gradients), on the card and on the CPU from the same weights
    and draws. The losses and step 1's gradients within EX_SHARE of their
    largest values; the weights apart at most ``max_apart`` entries, and
    none by more than ``max_lr`` lr. Returns the line's text."""
    losses, values, first = got
    want_l, want_v, want_first = want
    text = hold_shares(label, (
        ("losses", {"losses": np.array(losses)},
         {"losses": np.array(want_l)}),
        ("step 1's gradients", first, want_first)))
    apart, worst, entries = adam_weights_apart(values, want_v)
    if apart > max_apart or worst > max_lr * lr:
        fail("%s: weights after %d Adam steps on gpu(0): %d of %d entries "
             "past %g of their array's largest value, the largest "
             "difference %.3g = %.3g lr (limits %d entries, %g lr)"
             % (label, FIT_STEPS, apart, entries, EX_SHARE, worst,
                worst / lr, max_apart, max_lr))
    text.append("the weights (Adam, lr %g): %d of %d entries past %g of "
                "their array's largest value, the largest difference %.3g "
                "= %.3g lr (limits %d entries, %g lr)"
                % (lr, apart, entries, EX_SHARE, worst, worst / lr,
                   max_apart, max_lr))
    return "; ".join(text)


def gluon_examples_first_steps(mt):
    """The five examples' first steps on gpu(0) against the CPU from the
    same weights: the losses and the weights within EX_SHARE of their
    largest values; under Adam, step 1's gradients within EX_SHARE and
    the weights after FIT_STEPS steps but for GLUON_ADAM_APART entries,
    each within 2 lr. Prints one line an example."""
    gpu = mt.gpu(0)
    # the weights every example starts from: its own Xavier draw on the
    # CPU, read before its first step
    starts = {}
    with mt.cpu():
        for ex, main in GLUON_EXAMPLES:
            mt.random.seed(0)
            starts[ex] = main(mt, mt.cpu(), steps=0)[1]
    firsts = {}
    for label, ctx in (("gpu", gpu), ("cpu", mt.cpu())):
        with ctx:
            firsts[label] = gluon_examples_first(mt, ctx, starts)
    for ex, (losses, values, _g, first) in firsts["gpu"].items():
        want_l, want_v, _wg, want_first = firsts["cpu"][ex]
        lr = GLUON_ADAM_LR.get(ex)
        if lr is None:
            text = "; ".join(hold_shares(ex, (
                ("losses", {"losses": np.array(losses)},
                 {"losses": np.array(want_l)}),
                ("weights", values, want_v))))
        else:
            text = hold_adam_steps(ex, (losses, values, first),
                                   (want_l, want_v, want_first), lr,
                                   GLUON_ADAM_APART, 2.0)
        print("%s: first %d steps on gpu(0) against the CPU: %s (limit %g)"
              % (ex, FIT_STEPS, text, EX_SHARE), flush=True)


def gluon_examples_phase(mt, rnn_scan, card):
    """Phase 34: the five examples' first steps on gpu(0) against the CPU
    (gluon_examples_first_steps), then each main on gpu(0) to its own
    asserts; lstm_crf's bidirectional LSTM launches lstm_scan, counted
    from 0 just before its main. Returns {kernel: launches}."""
    gpu = mt.gpu(0)
    t0 = time.time()
    gluon_examples_first_steps(mt)
    print("Gluon examples: first steps %.1f s" % (time.time() - t0))
    launches = {}
    with gpu:
        for ex, main in GLUON_EXAMPLES:
            t0 = time.time()
            mt.random.seed(0)
            rnn_scan.reset_launches()
            text = main(mt, gpu)
            got = dict(rnn_scan.LAUNCHES)
            if ex == "lstm_crf":
                if got["lstm_scan"] < 2 * 60 * 4:
                    fail("lstm_crf: %d lstm_scan launches (want one a "
                         "direction a forward: at least %d)"
                         % (got["lstm_scan"], 2 * 60 * 4))
                launches = got
            print("%s's main on gpu(0): %s, its asserts hold; launches %s; "
                  "%.1f s | %s" % (ex, text, got, time.time() - t0, card),
                  flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 35: what nd.random_normal opens (A1, A9): the VAE at Kingma &
# Welling's MNIST widths, Bayes by Backprop, draws in a captured program;
# deformable convolution at R-FCN's res5 shape
# ---------------------------------------------------------------------------

# example/vae/vae_mnist.py's VAE at arXiv:1312.6114 section 5's MNIST
# widths and minibatch (500 hidden units, M = 100, 20 latents)
VAE_LATENT, VAE_HIDDEN, VAE_BATCH, VAE_LR, VAE_SEED = 20, 500, 100, 1e-3, 3
VAE_WINDOW = 50        # the ELBO's last 50 steps' mean below its first 50's
# the weights after FIT_STEPS Adam steps, card against CPU: no entry past
# EX_SHARE and none more than VAE_ADAM_LR_APART lr apart, three times the
# H100's reading (0 of 815,824 entries, the largest 8.03e-6 = 0.008 lr)
VAE_ADAM_LR_APART = 0.025


def vae_class(pkg):
    """vae_mnist.py's VAE in ``pkg``; ``eps`` is the reparameterization's
    draw (a test subclass gives both packages the same)."""
    nn = pkg.gluon.nn

    class VAE(pkg.gluon.Block):
        def __init__(self, n_latent=8, n_hidden=256, n_out=784, **kwargs):
            super().__init__(**kwargs)
            self.n_latent = n_latent
            with self.name_scope():
                self.enc = nn.HybridSequential()
                self.enc.add(nn.Dense(n_hidden, activation="tanh"))
                self.enc.add(nn.Dense(n_latent * 2))
                self.dec = nn.HybridSequential()
                self.dec.add(nn.Dense(n_hidden, activation="tanh"))
                self.dec.add(nn.Dense(n_out, activation="sigmoid"))

        def eps(self, x):
            return pkg.nd.random_normal(0, 1, shape=(x.shape[0],
                                                     self.n_latent))

        def forward(self, x):
            h = self.enc(x)
            mu = pkg.nd.slice_axis(h, axis=1, begin=0, end=self.n_latent)
            log_var = pkg.nd.slice_axis(h, axis=1, begin=self.n_latent,
                                        end=2 * self.n_latent)
            z = mu + pkg.nd.exp(0.5 * log_var) * self.eps(x)
            y = self.dec(z)
            kl = -0.5 * pkg.nd.sum(1 + log_var - mu * mu
                                   - pkg.nd.exp(log_var), axis=1)
            return y, kl
    return VAE


def vae_step(pkg, net, trainer, x):
    """One step of vae_mnist.py's loop: the -ELBO a row (Bernoulli
    reconstruction + KL) under record(), backward, trainer.step. Returns
    the rows' -ELBO (not read back)."""
    with pkg.autograd.record():
        yhat, kl = net(x)
        logloss = -pkg.nd.sum(x * pkg.nd.log(yhat + 1e-10)
                              + (1 - x) * pkg.nd.log(1 - yhat + 1e-10),
                              axis=1)
        elbo_loss = logloss + kl
    elbo_loss.backward()
    trainer.step(x.shape[0])
    return elbo_loss


def vae_weights(pkg):
    """The VAE's weights ({name: numpy}): the example's Xavier drawn on
    the CPU from VAE_SEED."""
    net = vae_class(pkg)(n_latent=VAE_LATENT, n_hidden=VAE_HIDDEN,
                         prefix="vae_")
    return gluon_weights(pkg, net, VAE_SEED, np.zeros((2, 784), np.float32),
                         pkg.init.Xavier())


def vae_net(pkg, ctx, weights, net_class=None):
    """The VAE at the published widths on ``ctx`` with ``weights``, and
    the example's Adam trainer."""
    net = (net_class or vae_class(pkg))(n_latent=VAE_LATENT,
                                        n_hidden=VAE_HIDDEN, prefix="vae_")
    net.initialize(pkg.init.Xavier(), ctx=ctx)
    net(pkg.nd.zeros((2, 784), ctx=ctx))
    gluon_load(pkg, net, weights, ctx)
    return net, pkg.gluon.Trainer(net.collect_params(), "adam",
                                  {"learning_rate": VAE_LR})


def vae_first(pkg, ctx, x, weights, steps=FIT_STEPS, net_class=None):
    """FIT_STEPS steps of the VAE on ``ctx`` from ``weights`` and the
    draws of VAE_SEED: (mean -ELBO a step, the weights after, step 1's
    gradients)."""
    net, trainer = vae_net(pkg, ctx, weights, net_class)
    params = net.collect_params()
    pkg.random.seed(VAE_SEED)
    losses, first = [], None
    for i in range(steps):
        xb = pkg.nd.array(x[i * VAE_BATCH:(i + 1) * VAE_BATCH], ctx=ctx)
        losses.append(float(vae_step(pkg, net, trainer, xb).mean()
                            .asnumpy()))
        if first is None:
            first = {k: p.grad().asnumpy() for k, p in params.items()}
    return losses, {k: p.data().asnumpy() for k, p in params.items()}, first


def vae_phase(mt, images, card):
    """The VAE of example/vae/vae_mnist.py at Kingma & Welling's MNIST
    widths (784-500-20 encoder, 20-500-784 decoder, batch 100, Adam 1e-3),
    eager Gluon with nd.random_normal every step: its first FIT_STEPS
    steps on gpu(0) against the CPU from the same weights and draws, then
    one epoch over ``images`` (phase 20's 60,000 MNIST digits, loaded once
    onto the card as [0, 1] floats and sliced there, as the example slices
    its array). The -ELBO must fall (the last VAE_WINDOW steps' mean below
    the first's); prints the ms a step and the share of it the draw's
    copy up from the CPU generator takes."""
    import torch
    t0 = time.time()
    gpu = mt.gpu(0)
    x_host = (images.reshape(len(images), -1) / 255.0).astype(np.float32)
    with mt.cpu():
        weights = vae_weights(mt)
        want = vae_first(mt, mt.cpu(), x_host, weights)
    with gpu:
        got = vae_first(mt, gpu, x_host, weights)
    print("VAE (784-%d-%d, batch %d): first %d steps on gpu(0) against the "
          "CPU: %s (limit %g) | %s"
          % (VAE_HIDDEN, VAE_LATENT, VAE_BATCH, FIT_STEPS,
             hold_adam_steps("the VAE", got, want, VAE_LR, 0,
                             VAE_ADAM_LR_APART), EX_SHARE, card),
          flush=True)
    with gpu:
        net, trainer = vae_net(mt, gpu, weights)
        x_all = mt.nd.array(x_host, ctx=gpu)
        mt.random.seed(VAE_SEED)
        losses = []
        torch.cuda.synchronize()
        t_fit = time.perf_counter()
        for i in range(0, len(x_host), VAE_BATCH):
            losses.append(vae_step(mt, net, trainer,
                                   x_all[i:i + VAE_BATCH]).mean().data)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t_fit) * 1e3 / len(losses)
        elbo = torch.stack(losses).cpu().numpy()
        # the draw alone, as a step makes it: on the CPU generator, then
        # copied up
        torch.cuda.synchronize()
        t_draw = time.perf_counter()
        for _ in range(len(losses)):
            mt.nd.random_normal(0, 1, shape=(VAE_BATCH, VAE_LATENT))
        torch.cuda.synchronize()
        draw_ms = (time.perf_counter() - t_draw) * 1e3 / len(losses)
        z = mt.nd.random_normal(0, 1, shape=(4, VAE_LATENT))
        samples = net.dec(z).asnumpy()
    head, tail = elbo[:VAE_WINDOW].mean(), elbo[-VAE_WINDOW:].mean()
    if not (np.isfinite(elbo).all() and tail < head):
        fail("the VAE's -ELBO did not fall over its epoch: first %d steps "
             "%.2f, last %d %.2f" % (VAE_WINDOW, head, VAE_WINDOW, tail))
    if samples.shape != (4, 784) or not np.isfinite(samples).all():
        fail("the VAE's decoder gave %s from the prior" % (samples.shape,))
    print("VAE one epoch on gpu(0): %d steps of %d over %d images in %.2f s, "
          "%.3f ms a step; -ELBO first %d steps %.2f -> last %d %.2f; "
          "nd.random_normal (%d x %d, drawn on the CPU, copied up) %.3f ms "
          "a step alone, %.1f%% of the step; phase %.1f s | %s"
          % (len(losses), VAE_BATCH, len(x_host), step_ms * len(losses)
             / 1e3, step_ms, VAE_WINDOW, head, VAE_WINDOW, tail, VAE_BATCH,
             VAE_LATENT, draw_ms, 100 * draw_ms / step_ms, time.time() - t0,
             card), flush=True)
    return step_ms


# example/bayesian-methods/bbb_toy.py at its own sizes
BBB_DIM, BBB_HIDDEN, BBB_CLASSES, BBB_PRIOR_SIGMA = 16, 32, 3, 1.0
BBB_LR, BBB_BATCH, BBB_EPOCHS, BBB_SEED = 5e-3, 128, 30, 51
# as VAE_ADAM_LR_APART: three times the H100's reading (0 of 1,286
# entries, the largest 2.38e-7 = 4.8e-5 lr)
BBB_ADAM_LR_APART = 1.5e-4


def bbb_data(n, seed):
    """bbb_toy.py's make_data: three prototypes in 16 dimensions plus
    noise."""
    protos = np.random.RandomState(0).uniform(
        -1, 1, (BBB_CLASSES, BBB_DIM)).astype(np.float32)
    r = np.random.RandomState(seed)
    y = r.randint(0, BBB_CLASSES, n)
    x = protos[y] + 0.2 * r.randn(n, BBB_DIM).astype(np.float32)
    return x.astype(np.float32), y.astype(np.float32)


def bbb_class(pkg):
    """bbb_toy.py's BayesMLP in ``pkg``: each weight a diagonal Gaussian
    (mu, rho -> softplus sigma) as two Parameters; ``eps`` is the
    reparameterization's draw."""
    class BayesMLP:
        def __init__(self):
            r = np.random.RandomState(1)
            self.params = {}
            for name, shape in [("w1", (BBB_DIM, BBB_HIDDEN)),
                                ("b1", (BBB_HIDDEN,)),
                                ("w2", (BBB_HIDDEN, BBB_CLASSES)),
                                ("b2", (BBB_CLASSES,))]:
                mu = pkg.gluon.Parameter(name + "_mu", shape=shape)
                mu.initialize(pkg.init.Constant(pkg.nd.array(
                    0.1 * r.randn(*shape).astype(np.float32))))
                rho = pkg.gluon.Parameter(name + "_rho", shape=shape)
                rho.initialize(pkg.init.Constant(pkg.nd.array(
                    np.full(shape, -3.0, np.float32))))
                self.params[name] = (mu, rho)

        def all_params(self):
            return [p for pair in self.params.values() for p in pair]

        def eps(self, shape):
            return pkg.nd.random_normal(0, 1, shape=shape)

        def sample(self, name):
            mu, rho = self.params[name]
            sigma = pkg.nd.log(1 + pkg.nd.exp(rho.data()))
            return mu.data() + sigma * self.eps(mu.shape), mu.data(), sigma

        def forward_sample(self, x):
            kl = 0.0
            acts = x
            for i, (w_name, b_name) in enumerate([("w1", "b1"),
                                                  ("w2", "b2")]):
                w, w_mu, w_sigma = self.sample(w_name)
                b, b_mu, b_sigma = self.sample(b_name)
                acts = pkg.nd.dot(acts, w) + b
                if i == 0:
                    acts = pkg.nd.relu(acts)
                for mu, sigma in ((w_mu, w_sigma), (b_mu, b_sigma)):
                    kl = kl + pkg.nd.sum(
                        pkg.nd.log(BBB_PRIOR_SIGMA / sigma)
                        + (sigma ** 2 + mu ** 2) / (2 * BBB_PRIOR_SIGMA ** 2)
                        - 0.5)
            return acts, kl
    return BayesMLP


def bbb_run(pkg, ctx, steps=None, model_class=None):
    """bbb_toy.py's main on ``ctx`` up to ``steps`` steps (None: its 30
    epochs, then its two asserts). Returns (losses, weights after, step
    1's gradients, the text of the asserts or None)."""
    pkg.random.seed(BBB_SEED)
    xtr, ytr = bbb_data(1024, 2)
    with ctx:
        model = (model_class or bbb_class(pkg))()
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        trainer = pkg.gluon.Trainer(model.all_params(), "adam",
                                    {"learning_rate": BBB_LR})
        n_batches = len(xtr) // BBB_BATCH
        losses, first, done = [], None, 0
        for _epoch in range(BBB_EPOCHS):
            for i in range(0, len(xtr), BBB_BATCH):
                if steps is not None and done == steps:
                    break
                x = pkg.nd.array(xtr[i:i + BBB_BATCH], ctx=ctx)
                y = pkg.nd.array(ytr[i:i + BBB_BATCH], ctx=ctx)
                with pkg.autograd.record():
                    logits, kl = model.forward_sample(x)
                    nll = pkg.nd.sum(loss_fn(logits, y))
                    elbo_loss = nll + kl / n_batches
                elbo_loss.backward()
                trainer.step(BBB_BATCH)
                losses.append(elbo_loss.data.detach() if steps is None
                              else float(elbo_loss.asnumpy()))
                if first is None:
                    first = {p.name: p.grad().asnumpy()
                             for p in model.all_params()}
                done += 1
        weights = {p.name: p.data().asnumpy() for p in model.all_params()}
        text = None if steps is not None else bbb_asserts(pkg, ctx, model)
    return losses, weights, first, text


def bbb_asserts(pkg, ctx, model, n_samples=16):
    """bbb_toy.py's two asserts: Monte-Carlo predictive accuracy on its
    test set above 0.9, and a higher predictive entropy off the training
    manifold than on it."""
    def mc_probs(x):
        probs = 0.0
        for _ in range(n_samples):
            logits, _ = model.forward_sample(pkg.nd.array(x, ctx=ctx))
            probs = probs + pkg.nd.softmax(logits, axis=-1).asnumpy()
        return probs / n_samples
    xte, yte = bbb_data(256, 3)
    probs_te = mc_probs(xte)
    acc = float((probs_te.argmax(1) == yte).mean())
    ent_in = -(probs_te * np.log(probs_te + 1e-10)).sum(axis=1).mean()
    x_ood = 6.0 * np.random.RandomState(9).randn(256, BBB_DIM).astype(
        np.float32)
    p_ood = mc_probs(x_ood)
    ent_out = -(p_ood * np.log(p_ood + 1e-10)).sum(axis=1).mean()
    if not (acc > 0.9 and ent_out > ent_in):
        fail("bbb_toy on %s: MC accuracy %.3f (limit 0.9), entropy in %.3f, "
             "off the manifold %.3f (must be higher)"
             % (ctx, acc, ent_in, ent_out))
    return "MC predictive accuracy %.3f (> 0.9), entropy %.3f in the data " \
        "against %.3f off it" % (acc, ent_in, ent_out)


def bbb_phase(mt, card):
    """bbb_toy.py mirrored at its own sizes: its first FIT_STEPS steps on
    gpu(0) against the CPU (the same weights and draws), then its main on
    gpu(0) to its asserts."""
    import torch
    t0 = time.time()
    got = bbb_run(mt, mt.gpu(0), steps=FIT_STEPS)[:3]
    want = bbb_run(mt, mt.cpu(), steps=FIT_STEPS)[:3]
    print("bbb_toy: first %d steps on gpu(0) against the CPU: %s (limit %g)"
          % (FIT_STEPS, hold_adam_steps("bbb_toy", got, want, BBB_LR, 0,
                                        BBB_ADAM_LR_APART),
             EX_SHARE), flush=True)
    losses, _w, _f, text = bbb_run(mt, mt.gpu(0))
    elbo = torch.stack(losses).cpu().numpy()
    print("bbb_toy's main on gpu(0): %d steps, ELBO loss %.1f -> %.1f; %s; "
          "%.1f s | %s" % (len(elbo), elbo[0], elbo[-1], text,
                           time.time() - t0, card), flush=True)


# a hybridized block's draws, captured on the card: (op, params, mean,
# deviation, excess kurtosis). Over n draws the sample mean's standard
# error is sd / sqrt(n) and the sample deviation's sd * sqrt((kurtosis +
# 2) / 4n); each is held within RB_SE standard errors (near 0.5% at 10^6)
RB_SHAPE = (1000, 1000)
RB_DRAWS = (("random_normal", {"loc": 2.0, "scale": 3.0}, 2.0, 3.0, 0.0),
            ("random_gamma", {"alpha": 3.0, "beta": 2.0}, 6.0, 12.0 ** 0.5,
             6.0 / 3.0),
            # k = 3, p = 0.5: 6 / k + p^2 / (k (1 - p))
            ("random_negative_binomial", {"k": 3, "p": 0.5}, 3.0,
             6.0 ** 0.5, 6.0 / 3.0 + 0.25 / 1.5))
RB_SE = 5.0


def random_block(pkg):
    """A HybridBlock adding a draw of each of RB_DRAWS to its input."""
    class Draws(pkg.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return [x + getattr(F, name)(shape=RB_SHAPE, **params)
                    for name, params, _m, _s, _t in RB_DRAWS]
    return Draws()


def hybrid_random_phase(mt, card):
    """A hybridized block that draws with F.random_normal, F.random_gamma
    and F.random_negative_binomial (a gamma and a Poisson draw) on the
    card: its second call captured, the third and fourth replayed; the
    replays' draws differ, and each replay's 10^6 draws hold the
    distribution's mean and deviation within RB_SE standard errors."""
    import torch
    gpu = mt.gpu(0)
    with gpu:
        mt.random.seed(0)
        block = random_block(mt)
        block.hybridize()
        x = mt.nd.zeros(RB_SHAPE, ctx=gpu)
        outs = [[o.data.clone() for o in block(x)] for _ in range(4)]
    torch.cuda.synchronize()
    stats = block.cache_stats()
    if stats.get("captures") != 1 or stats.get("replays", 0) < 2:
        fail("the random block was not captured and replayed: %s" % stats)
    text = []
    for i, (name, _p, mean, std, kurt) in enumerate(RB_DRAWS):
        if torch.equal(outs[2][i], outs[3][i]):
            fail("%s: two replays of the captured block drew the same "
                 "numbers" % name)
        n = outs[2][i].numel()
        se_m, se_s = std / n ** 0.5, std * ((kurt + 2) / (4 * n)) ** 0.5
        for call in (2, 3):
            v = outs[call][i].double()
            m, s = float(v.mean()), float(v.std())
            zm, zs = abs(m - mean) / se_m, abs(s - std) / se_s
            if not (zm <= RB_SE and zs <= RB_SE):
                fail("%s in the captured block, replay %d: mean %.5f, "
                     "deviation %.5f (want %.5f, %.5f; %.2f and %.2f "
                     "standard errors, limit %g)"
                     % (name, call - 1, m, s, mean, std, zm, zs, RB_SE))
            text.append("%s replay %d mean %.5f (%.5f, %.2f se), deviation "
                        "%.5f (%.5f, %.2f se)"
                        % (name, call - 1, m, mean, zm, s, std, zs))
    print("hybridized random block on gpu(0): %s; two replays differ; %s "
          "over %d draws a replay (limit %g standard errors) | %s"
          % (stats, "; ".join(text), RB_SHAPE[0] * RB_SHAPE[1], RB_SE,
             card), flush=True)


# _contrib_DeformableConvolution at Deformable ConvNets' res5 (Dai et al.,
# arXiv:1703.06211: R-FCN on ResNet-101 at 600 x 1000, stride 16, the
# dilated 3 x 3 of res5)
DEFORM_SHAPE = dict(data=(1, 512, 38, 63), offset=(1, 18, 38, 63),
                    weight=(512, 512, 3, 3))
DEFORM_PARAMS = {"kernel": (3, 3), "num_filter": 512, "pad": (2, 2),
                 "dilate": (2, 2), "no_bias": True}
DEFORM_SHARE = 1e-4    # card against CPU, of each array's largest value


def deformable_phase(mt, card):
    """_contrib_DeformableConvolution at R-FCN's res5 shape on gpu(0):
    forward + backward held once against the CPU (output and the three
    gradients within DEFORM_SHARE of their largest values, TF32 off), then
    timed (CUDA events, 10 calls) beside Convolution at the same shape."""
    import torch
    from mxtpu_torch.ops.registry import get_op
    rng = np.random.RandomState(5)
    host = {"data": rng.standard_normal(DEFORM_SHAPE["data"]),
            "offset": rng.uniform(-2, 2, DEFORM_SHAPE["offset"]),
            "weight": rng.standard_normal(DEFORM_SHAPE["weight"]) * 0.02}
    host = {k: v.astype(np.float32) for k, v in host.items()}
    d = DEFORM_SHAPE["data"]
    cot = rng.standard_normal((d[0], DEFORM_PARAMS["num_filter"])
                              + d[2:]).astype(np.float32)
    deform = get_op("_contrib_DeformableConvolution").fn
    conv = get_op("Convolution").fn

    def run(dev):
        t = {k: torch.from_numpy(v).to(dev).requires_grad_()
             for k, v in host.items()}
        out = deform(t["data"], t["offset"], t["weight"], **DEFORM_PARAMS)
        out.backward(torch.from_numpy(cot).to(dev))
        return {"out": out.detach().cpu().numpy(),
                **{"d" + k: v.grad.cpu().numpy() for k, v in t.items()}}
    dev = mt.gpu(0).torch_device()
    got = run(dev)
    want = run(torch.device("cpu"))
    err = largest_share_apart(got, want)
    if not err <= DEFORM_SHARE:
        fail("DeformableConvolution at res5 on gpu(0) differs from the CPU "
             "by %.3g of the largest value (limit %g)" % (err, DEFORM_SHARE))
    t = {k: torch.from_numpy(v).to(dev).requires_grad_()
         for k, v in host.items()}
    g = torch.from_numpy(cot).to(dev)
    forwards = {
        "deformable": lambda: deform(t["data"], t["offset"], t["weight"],
                                     **DEFORM_PARAMS),
        "convolution": lambda: conv(t["data"], t["weight"], None,
                                    **DEFORM_PARAMS)}
    ms = {label: (cuda_ms(fwd, iters=10, warmup=2),
                  cuda_ms(lambda: fwd().backward(g), iters=10, warmup=2))
          for label, fwd in forwards.items()}
    flops = 2 * np.prod(DEFORM_SHAPE["weight"]) * np.prod(d[2:])
    print("DeformableConvolution at R-FCN's res5 (data %s, offsets %s, "
          "weight %s, dilate 2, pad 2; f32, TF32 off): forward %.3f ms, "
          "forward + backward %.3f ms; Convolution at the same shape %.3f / "
          "%.3f ms (%.1fx / %.1fx); %.2f GFLOP a forward's product; card "
          "against the CPU within %.3g of the largest value | %s"
          % (DEFORM_SHAPE["data"], DEFORM_SHAPE["offset"],
             DEFORM_SHAPE["weight"], ms["deformable"][0],
             ms["deformable"][1], ms["convolution"][0],
             ms["convolution"][1], ms["deformable"][0] /
             ms["convolution"][0], ms["deformable"][1] /
             ms["convolution"][1], flops / 1e9, err, card), flush=True)
    return ms


def dense_ops_phase(mt, images, card):
    """Phase 35: the VAE (vae_phase), bbb_toy (bbb_phase), the captured
    random block (hybrid_random_phase) and the deformable convolution
    (deformable_phase). Returns (the VAE's ms a step, the deformable
    timings)."""
    t0 = time.time()
    vae_ms = vae_phase(mt, images, card)
    bbb_phase(mt, card)
    hybrid_random_phase(mt, card)
    deform_ms = deformable_phase(mt, card)
    print("dense ops phase: %.1f s" % (time.time() - t0), flush=True)
    return vae_ms, deform_ms


# -- phase 36: sparse arrays (ROADMAP A9's sparse half) -----------------------

# upstream MXNet's example/sparse/linear_classification on LIBSVM's
# avazu-app: 1,000,001 features (LIBSVM's ids from 1; column 0 unused),
# batch 8,192. The rows are synthetic, made from --seed
AV_FEATURES = 1_000_001
AV_BATCH = 8192
AV_FIELDS = 22               # Avazu's categorical fields: one stored 1 each
AV_TRAIN_BATCHES = 24        # the cut: 196,608 rows, 2 epochs
AV_TEST_BATCHES = 4          # held out: 32,768 rows
AV_EPOCHS = 2
AV_LR = 0.1                  # the example's Adam
AV_ACC = 0.70                # held-out accuracy the fit must pass
AV_PEAK_BYTES = 1 << 30      # the fit's rise in allocated memory (1 GiB)
AV_STEPS = 3                 # first steps held against the CPU
# the weights after each first step, card against CPU (the gradients'
# sums run in another order on the card: index_add_'s atomics): at most
# AV_APART entries past AV_ENTRY_TOL, AV_FAR past AV_FAR_LR lr (an Adam
# step that turns on a gradient's rounding), none past AV_APART_LR lr
AV_APART = 2000              # of the weight's 2,000,002 entries
AV_ENTRY_TOL = 1e-6
AV_FAR = 16
AV_FAR_LR = 0.01
AV_APART_LR = 2.0
AV_GRAD_SHARE = 1e-5         # step gradients: of their largest value
HBM_BYTES_PER_S = 3.35e12    # H100 SXM's memory rate (the bound's)

# gluon.contrib.nn.SparseEmbedding at LM1B's vocabulary and width
# (Jozefowicz et al. 2016, arXiv:1602.02410: 793,471 words, 512-wide
# embeddings): one Trainer step of lazy SGD over ids of (20, 128)
SE_VOCAB = 793_471
SE_DIM = 512
SE_IDS = (20, 128)
SE_LR = 0.5
SE_BACKWARD_BYTES = 100 << 20   # the backward's rise in allocated memory
SE_TOL = dict(rtol=1e-5, atol=1e-6)


def avazu_layout():
    """The columns of the 22 fields: sizes growing 1.6x a field (tens of
    columns for the smallest, as Avazu's C1 or banner_pos, hundreds of
    thousands for the largest, as device_ip or device_id), in order over
    columns 1 .. 1,000,000. Returns (sizes, first columns)."""
    r = 1.6 ** np.arange(AV_FIELDS)
    sizes = np.floor((AV_FEATURES - 1) * r / r.sum()).astype(np.int64)
    sizes[-1] += AV_FEATURES - 1 - sizes.sum()
    return sizes, 1 + np.concatenate([[0], np.cumsum(sizes)[:-1]])


def avazu_rows(rng, rows, w_true):
    """``rows`` click rows: one column a field, skewed within the field's
    range as click logs are (a column at u^4 of the range, u uniform: the
    first 1% of a field's columns take 32% of its rows), so a batch's
    rows repeat columns; the label is 1 where the planted weights of the
    row's columns sum above 0. Returns (columns (rows, 22), labels)."""
    sizes, first = avazu_layout()
    u = rng.random_sample((rows, AV_FIELDS))
    cols = first + np.floor(sizes * u ** 4).astype(np.int64)
    return cols, (w_true[cols].sum(1) > 0).astype(np.int64)


def write_libsvm_rows(path, cols, labels):
    """One LibSVM line a row: its label and each column with value 1
    (formatted a block of rows at a time)."""
    line = "%d" + " %d:1" * cols.shape[1] + "\n"
    with open(path, "w") as f:
        for i in range(0, len(cols), AV_BATCH):
            block = np.column_stack([labels[i:i + AV_BATCH],
                                     cols[i:i + AV_BATCH]])
            f.write((line * len(block)) % tuple(block.ravel().tolist()))


def avazu_files(seed, workdir):
    """The training and held-out LibSVM files from ``seed``: a planted
    weight on a fifth of the columns (N(0, 1)), AV_TRAIN_BATCHES and
    AV_TEST_BATCHES batches of rows."""
    rng = np.random.RandomState(seed + 36)
    w_true = np.where(rng.random_sample(AV_FEATURES) < 0.2,
                      rng.standard_normal(AV_FEATURES), 0.0)
    paths = []
    for name, batches in (("train", AV_TRAIN_BATCHES),
                          ("test", AV_TEST_BATCHES)):
        cols, labels = avazu_rows(rng, batches * AV_BATCH, w_true)
        paths.append(os.path.join(workdir, "avazu-%s.libsvm" % name))
        write_libsvm_rows(paths[-1], cols, labels)
    return paths


def sparse_lr_symbol(mt, features):
    """example/sparse/linear_classification.py's model: CSR data, a
    row_sparse (features, 2) weight, SoftmaxOutput over their dot."""
    data = mt.sym.var("data", stype="csr")
    label = mt.sym.var("softmax_label")
    w = mt.sym.var("weight", stype="row_sparse", shape=(features, 2))
    return mt.sym.SoftmaxOutput(mt.sym.dot(data, w), label, name="softmax")


class FirstBatches:
    """The first ``n`` batches of a data iterator, as an iterator."""

    def __init__(self, it, n):
        self.it, self.n = it, n
        self.provide_data, self.provide_label = it.provide_data, \
            it.provide_label
        self.batch_size = it.batch_size
        self.seen = 0

    def __iter__(self):
        return self

    def reset(self):
        self.it.reset()
        self.seen = 0

    def __next__(self):
        if self.seen == self.n:
            raise StopIteration
        self.seen += 1
        return self.it.next()

    next = __next__


def sparse_lr_fit(mt, ctx, train, seed, epochs, record=0, clock=None):
    """The example's Module.fit (Adam lr AV_LR, Normal(0.01) drawn after
    mt.random.seed(seed)) on ``ctx``. Records each step's stored gradient
    rows and, for the first ``record`` steps, the weight (host tensors);
    with ``clock``, the host seconds of next (and the next batch's
    staging), forward_backward, update (with the rows' recovery) and
    update_metric, each ending in a synchronize. Returns (module, rows a
    step, weights)."""
    import torch
    mod = mt.mod.Module(sparse_lr_symbol(mt, train.provide_data[0].shape[1]),
                        context=ctx, data_names=["data"],
                        label_names=["softmax_label"])
    rows, weights = [], []

    def step_end(param):
        ex = param.locals["self"]._exec_group.execs[0]
        rows.append(ex.grad_dict["weight"].nnz)
        if len(weights) < record:
            weights.append(ex.arg_dict["weight"]._data.detach().to(
                "cpu", copy=True))
    if clock is not None:
        sync = torch.cuda.synchronize if ctx.device_type == "gpu" \
            else (lambda: None)

        def timed(name, fn):
            def run(*a, **k):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                sync()
                clock[name] = clock.get(name, 0.0) + time.perf_counter() - t0
                return out
            return run
        train.next = timed("next", train.next)
        for name in ("forward_backward", "update", "update_metric"):
            setattr(mod, name, timed(name, getattr(mod, name)))
        mod.prepare = timed("next", mod.prepare)
    mt.random.seed(seed)
    mod.fit(train, num_epoch=epochs, optimizer="adam",
            optimizer_params={"learning_rate": AV_LR},
            initializer=mt.init.Normal(0.01), batch_end_callback=step_end)
    if clock is not None:
        del train.next
    return mod, rows, weights


def hold_sparse_steps(label, got, want, lr):
    """Weights after each of the first steps on the card (``got``) against
    the CPU's (``want``): at most AV_APART entries past AV_ENTRY_TOL and
    AV_FAR past AV_FAR_LR lr, none past AV_APART_LR lr (a weight whose
    Adam step turns on a gradient's rounding moves by about lr either
    way). Returns the line's text."""
    worst, apart, far = 0.0, 0, 0
    for g, w in zip(got, want):
        d = (g.float() - w.float()).abs()
        worst = max(worst, float(d.max()))
        apart = max(apart, int((d > AV_ENTRY_TOL).sum()))
        far = max(far, int((d > AV_FAR_LR * lr).sum()))
    text = ("weights after each of the first %d steps: at most %d entries "
            "past %g, %d past %g lr, the largest difference %.3g = %.3g lr "
            "(limits %d, %d, %g lr)" % (len(got), apart, AV_ENTRY_TOL, far,
                                        AV_FAR_LR, worst, worst / lr,
                                        AV_APART, AV_FAR, AV_APART_LR))
    if apart > AV_APART or far > AV_FAR or worst > AV_APART_LR * lr:
        fail("%s against the CPU: %s" % (label, text))
    return text


def avazu_phase(mt, seed, workdir, card):
    """Phase 36a: the example's sparse logistic regression at Avazu-app's
    width through Module.fit on gpu(0), fed CSR batches by LibSVMIter
    (no dense batch: the fit's rise in allocated memory must stay under
    AV_PEAK_BYTES; a dense one would be 32.8 GB); its first AV_STEPS
    steps against the CPU from the same weights and batches (stored rows
    equal, weights by hold_sparse_steps); every step's stored rows at most
    a batch's 8,192 x 22; held-out accuracy above AV_ACC; ms a step by
    phase beside the step's bound."""
    import torch
    t0 = time.time()
    gpu = mt.gpu(0)
    train_path, test_path = avazu_files(seed, workdir)
    t_files = time.time() - t0
    t_parse = time.time()
    train = mt.io.LibSVMIter(data_libsvm=train_path,
                             data_shape=(AV_FEATURES,), batch_size=AV_BATCH)
    test = mt.io.LibSVMIter(data_libsvm=test_path, data_shape=(AV_FEATURES,),
                            batch_size=AV_BATCH)
    t_parse = time.time() - t_parse
    with mt.cpu():
        _m, cpu_rows, cpu_w = sparse_lr_fit(
            mt, mt.cpu(), FirstBatches(train, AV_STEPS), seed, 1,
            record=AV_STEPS)
    train.reset()
    clock = {}
    with gpu:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t_fit = time.perf_counter()
        mod, rows, gpu_w = sparse_lr_fit(mt, gpu, train, seed, AV_EPOCHS,
                                         record=AV_STEPS, clock=clock)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t_fit
        peak = torch.cuda.max_memory_allocated() - base
        ex = mod._exec_group.execs[0]
        kinds = (type(ex.arg_dict["data"]).__name__,
                 type(ex.arg_dict["weight"]).__name__,
                 type(ex.grad_dict["weight"]).__name__)
        acc = dict(mod.score(test, mt.metric.Accuracy()))["accuracy"]
    steps = len(rows)
    if kinds != ("CSRNDArray", "RowSparseNDArray", "RowSparseNDArray"):
        fail("Avazu fit: the executor's data, weight and gradient are %s"
             % (kinds,))
    if steps != AV_EPOCHS * AV_TRAIN_BATCHES:
        fail("Avazu fit took %d steps, want %d" % (
            steps, AV_EPOCHS * AV_TRAIN_BATCHES))
    if rows[:AV_STEPS] != cpu_rows:
        fail("Avazu fit: stored gradient rows of the first %d steps %s on "
             "the card, %s on the CPU" % (AV_STEPS, rows[:AV_STEPS],
                                          cpu_rows))
    if max(rows) > AV_BATCH * AV_FIELDS:
        fail("Avazu fit: a step stored %d gradient rows, more than a "
             "batch's %d" % (max(rows), AV_BATCH * AV_FIELDS))
    held = hold_sparse_steps("Avazu fit", gpu_w, cpu_w, AV_LR)
    if peak >= AV_PEAK_BYTES:
        fail("Avazu fit: allocated memory rose %.1f MB over the fit (limit "
             "%.0f MB): something densified" % (peak / 2 ** 20,
                                                AV_PEAK_BYTES / 2 ** 20))
    if not acc > AV_ACC:
        fail("Avazu fit: held-out accuracy %.4f (limit %.2f)" % (acc, AV_ACC))
    nnz = AV_BATCH * AV_FIELDS
    mean_rows = float(np.mean(rows))
    # a step's least bytes: the touched rows of the weight and of Adam's
    # mean and variance, each read and written (2 floats a row), and the
    # batch's CSR read once (float32 values, int64 columns and pointers)
    bound_bytes = mean_rows * 2 * 4 * 6 + nnz * (4 + 8) + (AV_BATCH + 1) * 8
    bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
    step_ms = fit_s * 1e3 / steps
    split = ", ".join("%s %.3f" % (k, v * 1e3 / steps)
                      for k, v in sorted(clock.items()))
    print("Avazu sparse LR (%s features, batch %d, %d fields a row; %d "
          "train + %d held-out batches, %d epochs): first %d steps on gpu(0) "
          "against the CPU: stored gradient rows %s both, %s; held-out "
          "accuracy %.4f (limit %.2f); %d steps, %.3f ms a step (host clock, "
          "the parts each ending in a synchronize: %s ms); stored gradient "
          "rows a step mean %.0f, max %d (limit %d); the step's bound %.5f "
          "ms (%.0f bytes at 3.35 TB/s), %.2f%% of the step; allocated "
          "memory's rise over the fit %.1f MB (limit %.0f; a dense batch "
          "alone: %.1f GB); files written in %.1f s, parsed in %.1f s; "
          "phase %.1f s | %s"
          % (format(AV_FEATURES, ","), AV_BATCH, AV_FIELDS, AV_TRAIN_BATCHES,
             AV_TEST_BATCHES, AV_EPOCHS, AV_STEPS, cpu_rows, held, acc,
             AV_ACC, steps, step_ms, split, mean_rows, max(rows), nnz,
             bound_ms, bound_bytes, 100 * bound_ms / step_ms,
             peak / 2 ** 20, AV_PEAK_BYTES / 2 ** 20,
             AV_BATCH * AV_FEATURES * 4 / 1e9, t_files, t_parse,
             time.time() - t0, card), flush=True)
    return {"ms": step_ms, "bound_ms": bound_ms, "peak_mb": peak / 2 ** 20,
            "acc": acc, "rows": mean_rows}


def sparse_lc_main(mt, ctx, steps=AV_STEPS, w0=None):
    """example/sparse/linear_classification.py's main, line for line, on
    ``ctx`` (``mt`` the port or mxtpu; ``w0`` the starting weight in place
    of the example's Normal(0.01) draw). Returns (its train accuracy,
    [(stored gradient rows, their values, the weight)] after each of the
    first ``steps`` steps); the example's own asserts raise."""
    import tempfile
    import logging as _logging
    mt.random.seed(0)
    rng = np.random.RandomState(0)
    n, d = 512, 64
    w_true = np.zeros(d, np.float32)
    w_true[rng.choice(d, 8, replace=False)] = rng.randn(8)
    X = (rng.rand(n, d) < 0.1) * rng.randn(n, d).astype(np.float32)
    y = (X @ w_true > 0).astype(np.int32)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train.libsvm")
        with open(path, "w") as f:
            for row, lab in zip(X, y):
                idx = np.nonzero(row)[0]
                f.write("%d %s\n" % (lab, " ".join(
                    "%d:%.4f" % (i, row[i]) for i in idx)))
        it = mt.io.LibSVMIter(data_libsvm=path, data_shape=(d,),
                              batch_size=64)
    out = sparse_lr_symbol(mt, d)
    _logging.disable(_logging.INFO)
    mod = mt.mod.Module(out, context=ctx, data_names=["data"],
                        label_names=["softmax_label"])
    first = []

    def grab(param):
        if len(first) < steps:
            ex = param.locals["self"]._exec_group.execs[0]
            g = ex.grad_dict["weight"]
            first.append((g.indices.asnumpy(), g.data.asnumpy(),
                          ex.arg_dict["weight"].asnumpy()))
    try:
        mod.fit(it, num_epoch=10, optimizer="adam",
                optimizer_params={"learning_rate": 0.1},
                initializer=mt.init.Normal(0.01), batch_end_callback=grab,
                arg_params=None if w0 is None else {
                    "weight": mt.nd.array(w0, ctx=ctx)})
    finally:
        _logging.disable(_logging.NOTSET)
    it.reset()
    acc = dict(mod.score(it, mt.metric.Accuracy()))["accuracy"]
    assert acc > 0.8, acc
    ex = mod._exec_group.execs[0]
    assert type(ex.arg_dict["data"]).__name__ == "CSRNDArray"
    assert type(ex.arg_dict["weight"]).__name__ == "RowSparseNDArray"
    assert type(ex.grad_dict["weight"]).__name__ == "RowSparseNDArray"
    arg_st, _, _ = out.infer_storage_type()
    assert dict(zip(out.list_arguments(), arg_st)) == {
        "data": "csr", "weight": "row_sparse", "softmax_label": "default"}
    return acc, first


def sparse_example_phase(mt, card):
    """Phase 36b: the example's main on gpu(0), its first AV_STEPS steps'
    stored gradient rows (equal), gradients (within AV_GRAD_SHARE of their
    largest value) and weights (hold_sparse_steps) against the CPU's,
    then its own asserts."""
    import torch
    gpu = mt.gpu(0)
    with mt.cpu():
        _acc, want = sparse_lc_main(mt, mt.cpu())
    with gpu:
        acc, got = sparse_lc_main(mt, gpu)
    worst = 0.0
    for (gi, gv, _), (wi, wv, _) in zip(got, want):
        if not np.array_equal(gi, wi):
            fail("linear_classification: stored gradient rows %s on the "
                 "card, %s on the CPU" % (gi.tolist(), wi.tolist()))
        worst = max(worst, float(np.abs(gv - wv).max()))
    scale = max(float(np.abs(wv).max()) for _i, wv, _w in want)
    if worst > AV_GRAD_SHARE * scale:
        fail("linear_classification: step gradients on the card differ "
             "from the CPU's by %.3g (limit %.3g of %.3g)"
             % (worst, AV_GRAD_SHARE, scale))
    held = hold_sparse_steps("linear_classification",
                             [torch.from_numpy(w) for _i, _g, w in got],
                             [torch.from_numpy(w) for _i, _g, w in want], 0.1)
    print("example/sparse/linear_classification.py on gpu(0): first %d "
          "steps against the CPU: stored gradient rows equal (%s), "
          "gradients within %.3g (limit %g of %.3g), %s; its asserts hold, "
          "train accuracy %.4f (> 0.8) | %s"
          % (AV_STEPS, [len(i) for i, _g, _w in got], worst, AV_GRAD_SHARE,
             scale, held, acc, card), flush=True)


def sparse_embedding_phase(mt, seed, card):
    """Phase 36c: gluon.contrib.nn.SparseEmbedding at LM1B's vocabulary
    and width (793,471 x 512 f32, 1.63 GB on the card): one Trainer step
    of lazy SGD over ids of SE_IDS under autograd.record(), a random head
    as the loss's gradient. The compact gradient stores at most the ids'
    2,560 rows; the backward's rise in allocated memory stays under
    SE_BACKWARD_BYTES (no (vocab, dim) tensor); the touched rows after the
    step equal a CPU computation over those rows alone (SE_TOL), and
    every other row keeps its bits."""
    import torch
    gpu = mt.gpu(0)
    dev = gpu.torch_device()
    rng = np.random.RandomState(seed + 362)
    ids = rng.randint(0, SE_VOCAB, SE_IDS)
    ids[0, :16] = ids[1, :16]            # repeated ids: their rows sum
    head = rng.standard_normal(SE_IDS + (SE_DIM,)).astype(np.float32)
    slots = int(np.prod(SE_IDS))
    gen = torch.Generator(device=dev).manual_seed(seed)
    with gpu:
        emb = mt.gluon.contrib.nn.SparseEmbedding(SE_VOCAB, SE_DIM,
                                                  nnz_max=slots)
        emb.weight.set_data(mt.nd.NDArray(torch.randn(
            (SE_VOCAB, SE_DIM), generator=gen, device=dev), gpu))
        trainer = mt.gluon.Trainer(emb.collect_params(), "sgd",
                                   {"learning_rate": SE_LR})
        w = emb.weight.data()._data
        before = w.detach().clone()
        x = mt.nd.array(ids.astype(np.float32), ctx=gpu)
        y = mt.nd.array(head, ctx=gpu)
        torch.cuda.synchronize()
        t_step = time.perf_counter()
        with mt.autograd.record():
            loss = mt.nd.sum(emb(x) * y)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss.backward()
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated() - base
        grad = emb.weight.grad()
        stored, cap = grad.nnz, grad.nnz_max
        trainer.step(SE_IDS[0])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t_step) * 1e3
        changed = torch.nonzero((w.detach() != before).any(1)).reshape(-1)
        touched = np.unique(ids)
        got = w.detach()[torch.from_numpy(touched).to(dev)].cpu().numpy()
        start = before[torch.from_numpy(touched).to(dev)].cpu().numpy()
    # the CPU's step over the touched rows alone: each row's gradient the
    # head's rows of its ids summed, SGD at lr / batch
    g = np.zeros((touched.size, SE_DIM), np.float32)
    np.add.at(g, np.searchsorted(touched, ids.reshape(-1)),
              head.reshape(-1, SE_DIM))
    want = start - SE_LR * (g / SE_IDS[0])
    err = float(np.abs(got - want).max())
    moved = set(changed.cpu().numpy().tolist())
    if stored != touched.size or cap != slots:
        fail("SparseEmbedding: the gradient stores %d rows in %d slots; the "
             "ids touch %d, the slots are %d" % (stored, cap, touched.size,
                                                 slots))
    if rise >= SE_BACKWARD_BYTES:
        fail("SparseEmbedding: allocated memory rose %.1f MB over the "
             "backward (limit %.0f MB): a (vocab, dim) tensor was made"
             % (rise / 2 ** 20, SE_BACKWARD_BYTES / 2 ** 20))
    if not np.allclose(got, want, **SE_TOL):
        fail("SparseEmbedding: touched rows after the step differ from the "
             "CPU's by %.3g (%s)" % (err, SE_TOL))
    if not moved <= set(touched.tolist()):
        fail("SparseEmbedding: %d rows the ids do not touch changed"
             % len(moved - set(touched.tolist())))
    print("SparseEmbedding %s x %d f32 (%.2f GB) on gpu(0): one lazy SGD "
          "Trainer step over ids %s: gradient stores %d rows in %d slots; "
          "allocated memory's rise over the backward %.2f MB (limit %.0f; a "
          "dense gradient: %.0f MB); touched rows against the CPU within "
          "%.3g (%s); %d rows changed, every other row's bits kept; record + "
          "backward + step %.1f ms (host clock) | %s"
          % (format(SE_VOCAB, ","), SE_DIM, SE_VOCAB * SE_DIM * 4 / 1e9,
             SE_IDS, stored, cap, rise / 2 ** 20, SE_BACKWARD_BYTES / 2 ** 20,
             SE_VOCAB * SE_DIM * 4 / 2 ** 20, err, SE_TOL, len(moved),
             step_ms, card), flush=True)
    return {"backward_mb": rise / 2 ** 20, "ms": step_ms}


def sparse_phase(mt, seed, workdir, card):
    """Phase 36: the sparse arrays on the card (avazu_phase,
    sparse_example_phase, sparse_embedding_phase). Returns (the Avazu
    fit's numbers, the SparseEmbedding step's)."""
    t0 = time.time()
    av = avazu_phase(mt, seed, workdir, card)
    sparse_example_phase(mt, card)
    se = sparse_embedding_phase(mt, seed, card)
    print("sparse phase: %.1f s" % (time.time() - t0), flush=True)
    return av, se


# ---------------------------------------------------------------------------
# Phase 37: durability and precision (ROADMAP A10). MXTPU_AMP=bf16 in the
# captured Module step (ResNet-50, config 2, and the PTB-width bucketed LM,
# config 4, whose lstm_scan then runs in bfloat16), CheckpointManager in its
# Gluon form, MXNet's binary .params through Module.load, and
# train_imagenet.py --dtype float16
# ---------------------------------------------------------------------------

AMP_U = 2.0 ** -8            # bfloat16's unit roundoff (8 significant bits)
AMP_STEPS = 3                # first AMP steps held against float32's
AMP_TIMED_STEPS, AMP_TURNS = 5, 2
# The AMP step against the float32 one from the same weights and batch: a
# bfloat16 forward rounds every activation to AMP_U, and BatchNorm (in
# float32) keeps each of the 50 layers near unit scale, so the loss of
# each of the first steps (cross-entropy ~ln(1000)) is held within
# AMP_LOSS_ULPS units of AMP_U relative (readings on the H100: 0.06 U at
# the first step, 0.6 U at the third; a run whose weights never moved
# would score the first step's 6.99 at the third, 10.6% above float32's
# 6.32, and fails it). The weights are held at the first step, where both
# runs start from the same weights and batch: the norm of the AMP step
# over the float32 step's within 1 +- AMP_MOVE_TOL (rounding noise nearly
# orthogonal to the step changes its norm little: 1.0003 on the H100; a
# skipped step reads 0, a half-size step 0.5). Its direction: at random
# initialisation much of the step is noise at bfloat16's scale, in mxtpu
# as in the port (cosine 0.40 with float32's on the H100), so it is held
# against the float32 step's own spread at that scale, read in this run:
# the float32 step from weights each moved by AMP_U / 2 (random sign; the
# largest rounding of a weight to bfloat16). The AMP step's part across
# float32's for each part along it must stay within AMP_DIR_SPREAD times
# that step's (H100: 2.28 against 1.46, 1.56 times;
# tests/test_torch_module_amp.py holds both packages' first ResNet step
# to these bands). Steps 2-3 are held by their losses: at
# lr 0.1 the float32 run alone, started one float32 ulp apart, ends 0.677
# of its move apart after 3 steps (RN_SPREAD's note)
AMP_LOSS_ULPS = 8
AMP_MOVE_TOL, AMP_DIR_SPREAD = 0.1, 2.0
AMP_SCALE = 1024.0           # the overflow drill's loss scale
AMP_FAULT = "kind=nan_grad,point=module.step,nth=3"
# The bucketed LM under AMP against float32 over phase 28's sentences and
# depth (3 epochs of Adam from one Xavier draw): the log of the perplexity
# after the fit (its cross-entropy, ~8.5 nats there), relative, apart by
# at most AMP_PPL_SPREAD times the fit's own spread. Adam (eps 1e-8) moves
# a weight by about lr whatever the size of its gradient, so the fit's end
# amplifies any difference in the first steps. Its spread is read in this
# run at bfloat16's scale: the float32 fit from weights each moved by
# AMP_U / 2 (random sign), and the AMP fit from masters one float32 ulp
# apart (which flips the bfloat16 rounding of the masters that lie near a
# rounding boundary); the float32 fit from weights one ulp apart is
# printed beside them (it reads far less: an ulp is 2^-16 of AMP_U). The
# band is AMP_PPL_SPREAD times the largest of three such spreads (the
# float32 fit from two draws of U/2 apart, the AMP fit from one ulp
# apart). Readings on the H100: AMP 2.55 and 2.45 times it (0.78%, 0.73%
# against 0.30%); an AMP fit at half the learning rate, run as the
# band's control, 12 times it (3.6%), and it must fall outside the band
AMP_PPL_SPREAD = 4.0
AMP_BUCKET_STEPS = 5         # timed steps a bucket
# CheckpointManager: resnet18_v1 saved at CK_SAVE, then CK_MORE steps
CK_SAVE, CK_MORE = 5, 3
F16_STEPS = 5                # --dtype float16's captured steps


def bf16_apart(params, seed):
    """{name: numpy} with every value moved by AMP_U / 2 relative up or
    down (bfloat16's rounding at its largest), the sign drawn from
    RandomState(seed)."""
    rng = np.random.RandomState(seed)
    return {k: (v * (1 + AMP_U / 2 * rng.choice([-1, 1], v.shape)))
            .astype(v.dtype) for k, v in sorted(params.items())}


class FirstStepWeights:
    """A fit's batch_end_callback: the module's weights ({name: numpy})
    after its first step."""

    def __init__(self):
        self.w = None

    def __call__(self, param):
        if self.w is None:
            self.w = module_params(param.locals["self"])


def step_size_and_cosine(got, want, start, got_start=None):
    """(||got - got_start|| / ||want - start||, the cosine between the
    two moves) over every array of the dicts; ``got_start`` is
    ``start`` unless given."""
    keys = sorted(want)
    got_start = start if got_start is None else got_start
    a = np.concatenate([(got[k] - got_start[k]).ravel() for k in keys])
    b = np.concatenate([(want[k] - start[k]).ravel() for k in keys])
    na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
    return na / nb, float(a @ b) / (na * nb) if na and nb else 0.0


def noise_to_signal(cos):
    """tan of the angle between two moves: the part of one move across
    the other over the part along it (infinite at a right angle or
    beyond)."""
    return (1 - cos * cos) ** 0.5 / cos if cos > 0 else float("inf")


def hold_first_step(label, got, want, start, ref_cos):
    """Fail unless the AMP run's first step ``got`` is float32's ``want``
    in size (within AMP_MOVE_TOL) and no more than AMP_DIR_SPREAD times
    as far off its direction as the float32 step taken from weights
    AMP_U / 2 apart is (``ref_cos``: that step's cosine with ``want``).
    Returns (size ratio, cosine)."""
    ratio, cos = step_size_and_cosine(got, want, start)
    if not abs(ratio - 1) <= AMP_MOVE_TOL or \
            not noise_to_signal(cos) <= \
            AMP_DIR_SPREAD * noise_to_signal(ref_cos):
        fail("ResNet-50 %s: the first step is %.4f of float32's in size "
             "(limit 1 +- %g) at cosine %.4f, %.3f across for each along "
             "(limit %g x the float32 step's from weights U/2 apart: "
             "cosine %.4f, %.3f)"
             % (label, ratio, AMP_MOVE_TOL, cos, noise_to_signal(cos),
                AMP_DIR_SPREAD, ref_cos, noise_to_signal(ref_cos)))
    return ratio, cos


def resnet_amp_fit(mt, seed, steps, args, aux, amp, scale=0.0,
                   callbacks=None, tf32=False):
    """train_imagenet.py --benchmark 1's fit call on gpu(0), captured
    (kvstore "local"), ``steps`` steps of ResNet-50 at batch RN_BATCH from
    the given weights, with MXTPU_AMP=bf16 when ``amp`` (and
    MXTPU_AMP_LOSS_SCALE=``scale``). Returns (module, iterator)."""
    with env_set(MXTPU_AMP="bf16" if amp else "",
                 MXTPU_AMP_LOSS_SCALE=scale), tf32_mode(tf32):
        np.random.seed(seed)
        mt.random.seed(seed)
        mod, it = imagenet_fit(mt, resnet_symbol(mt, 50, RN_SHAPE,
                                                 RN_CLASSES),
                               RN_BATCH, steps * RN_BATCH, 1, RN_SHAPE,
                               RN_CLASSES, context=mt.gpu(0),
                               kvstore="local", arg_params=args,
                               aux_params=aux, batch_end_callback=callbacks)
    group = mod._fused._group if mod._fused is not None else None
    if group is None or group.amp != ("bf16" if amp else None):
        fail("ResNet-50 (MXTPU_AMP=%s): the captured step's AMP mode is %s"
             % ("bf16" if amp else "", group and group.amp))
    return mod, it


def fused_store_dtypes(group):
    """{"masters"/"states"/"aux": the dtypes found} of a fused group."""
    import torch
    from mxtpu_torch.module.fused import _leaves
    return {
        "masters": {a._data.dtype for a in group.param_store.values()},
        "states": {t.dtype for st in group.states.values()
                   for t in _leaves(st) if isinstance(t, torch.Tensor)},
        "aux": {a._data.dtype for a in group.aux_store.values()}}


def written_tensors(group):
    """Clones of every tensor a fused step writes: the weights, the
    optimizer states, the aux states, t and the metric accumulator."""
    from mxtpu_torch.module.fused import _leaves
    out = {"w:" + k: a._data.clone() for k, a in group.param_store.items()}
    out.update(("a:" + k, a._data.clone())
               for k, a in group.aux_store.items())
    for slot, st in group.states.items():
        out.update(("s:%d:%d" % (slot, i), t.clone())
                   for i, t in enumerate(_leaves(st)))
    out["t"] = group.t_dev.clone()
    if group.metric_acc is not None:
        out["metric"] = group.metric_acc.clone()
    return out


def timed_steps(mod, it, metric, steps, tf32=False):
    """Host ms a step of ``steps`` fit_steps, the card waited for."""
    import torch
    with tf32_mode(tf32):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit_steps(mod, it, metric, steps=steps)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def resnet_amp_phase(mt, seed, card, w0, bound):
    """(a) ResNet-50 under MXTPU_AMP=bf16 at 224, batch 128, captured:
    its first AMP_STEPS steps against float32's (TF32 off) from phase 26's
    weights ``w0``, the store's dtypes, one capture, ms a step in turns
    with float32 TF32 off and then with float32 TF32 on (two ResNet-50
    graphs alive at a time: three would not fit beside what earlier
    phases keep) beside the bf16 bound (``bound``: phase 14's FLOPs and
    bytes), the profiler's top kernels of one replay and the peak
    memory. (b) the overflow drill. Returns {label: ms a step}."""
    import gc
    import torch
    from mxtpu_torch import fault
    args0, aux0 = w0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    # the float32 step's own spread at bfloat16's scale: one step from
    # weights AMP_U / 2 apart (a first batch runs for real: no capture)
    ref_w, ref_first = bf16_apart(args0, seed), FirstStepWeights()
    ref_mod, _it = resnet_amp_fit(mt, seed, 1, ref_w, aux0, False,
                                  callbacks=[ref_first])
    del ref_mod, _it
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses = {"AMP bf16": StepLosses(), "float32, TF32 off": StepLosses()}
    firsts = {k: FirstStepWeights() for k in losses}
    amp_mod, amp_it = resnet_amp_fit(mt, seed, AMP_STEPS, args0, aux0,
                                     True, callbacks=[losses["AMP bf16"],
                                                      firsts["AMP bf16"]])
    amp_text = capture_report(amp_mod, AMP_STEPS, "ResNet-50 AMP")[0]
    torch.cuda.synchronize()
    amp_peak = torch.cuda.max_memory_allocated() - base
    f32_mod, f32_it = resnet_amp_fit(
        mt, seed, AMP_STEPS, args0, aux0, False,
        callbacks=[losses["float32, TF32 off"], firsts["float32, TF32 off"]])
    capture_report(f32_mod, AMP_STEPS, "ResNet-50 float32")
    group = amp_mod._fused._group
    dtypes = fused_store_dtypes(group)
    if any(d != {torch.float32} for d in dtypes.values()):
        fail("ResNet-50 AMP: the store holds %s (want float32 masters, "
             "momenta and BatchNorm statistics)" % dtypes)
    share = norm_share(module_params(amp_mod), module_params(f32_mod),
                       args0)
    f32_first = firsts["float32, TF32 off"].w
    ref_ratio, ref_cos = step_size_and_cosine(ref_first.w, f32_first, args0,
                                              got_start=ref_w)
    ratio, cos = hold_first_step("AMP", firsts["AMP bf16"].w, f32_first,
                                 args0, ref_cos)
    half = {k: (args0[k] + v) / 2 for k, v in firsts["AMP bf16"].w.items()}
    half_ratio = step_size_and_cosine(half, f32_first, args0)[0]
    got_l = losses["AMP bf16"].values()
    want_l = losses["float32, TF32 off"].values()
    loss_off = max(abs(g - w) / abs(w) for g, w in zip(got_l, want_l))
    if not all(np.isfinite(got_l)) or \
            not loss_off <= AMP_LOSS_ULPS * AMP_U:
        fail("ResNet-50 AMP against float32 over %d steps: losses %s "
             "against %s (%.3g relative, limit %d x 2^-8)"
             % (AMP_STEPS, got_l, want_l, loss_off, AMP_LOSS_ULPS))
    print("ResNet-50 MXTPU_AMP=bf16 (224^2, batch %d, captured; fit.py's "
          "SGD from phase 26's MSRAPrelu weights): %s; store dtypes %s; "
          "first %d steps' losses %s against float32's %s (largest %.3g "
          "relative, limit %d x 2^-8 = %.4g); the first step %.4f of "
          "float32's in size (limit 1 +- %g; the AMP step halved would "
          "read %.4f), cosine %.4f, %.3f across for each along (limit %g "
          "x the float32 step's from weights U/2 apart: size %.4f, cosine "
          "%.4f, %.3f); after %d steps the "
          "weights %.4f of the float32 run's move apart (not held: the "
          "float32 run alone ends 0.677 apart from weights one ulp apart); "
          "peak memory %.2f GB above the phase's start | %s"
          % (RN_BATCH, amp_text, {k: sorted(str(d) for d in v)
                                  for k, v in dtypes.items()}, AMP_STEPS,
             ", ".join("%.5f" % v for v in got_l),
             ", ".join("%.5f" % v for v in want_l), loss_off, AMP_LOSS_ULPS,
             AMP_LOSS_ULPS * AMP_U, ratio, AMP_MOVE_TOL, half_ratio, cos,
             noise_to_signal(cos), AMP_DIR_SPREAD, ref_ratio, ref_cos,
             noise_to_signal(ref_cos), AMP_STEPS, share, amp_peak / 1e9,
             card),
          flush=True)
    # ms a captured step in turns: AMP against float32 TF32 off, then
    # against float32 TF32 on (its graph captured under TF32)
    metric = mt.metric.create([mt.metric.create("accuracy")])
    times = {"AMP bf16": [], "float32, TF32 off": [], "float32, TF32 on": []}
    for label, tf32 in (("float32, TF32 off", False),
                        ("float32, TF32 on", True)):
        if tf32:
            del f32_mod, f32_it
            gc.collect()
            torch.cuda.empty_cache()
            f32_mod, f32_it = resnet_amp_fit(mt, seed, AMP_STEPS, args0,
                                             aux0, False, tf32=True)
            capture_report(f32_mod, AMP_STEPS, "ResNet-50 TF32")
        for _ in range(AMP_TURNS):
            times["AMP bf16"].append(timed_steps(amp_mod, amp_it, metric,
                                                 AMP_TIMED_STEPS))
            times[label].append(timed_steps(f32_mod, f32_it, metric,
                                            AMP_TIMED_STEPS, tf32=tf32))
    del f32_mod, f32_it
    ms = {k: float(np.median(v)) for k, v in times.items()}
    conv_mm, nbytes = bound
    ops = sum(conv_mm) / PEAK_BF16_FLOPS * 1e3
    mem = nbytes / PEAK_BYTES_S * 1e3
    amp_bound, amp_by = (ops, "operations") if ops >= mem else (mem, "bytes")
    busy, top = device_time(
        lambda: fit_steps(amp_mod, amp_it, metric, steps=1), 1)
    print("ResNet-50 captured ms a step in turns of %d steps (median): %s; "
          "the bf16 bound %.3f ms (%s: %.4g FLOPs at 989 TFLOP/s, %.4g "
          "bytes at 3.35 TB/s), AMP at %.1f%% of it; float32's bounds %.3f "
          "(TF32 off) / %.3f (on); one AMP replay: %s; %s | %s"
          % (AMP_TIMED_STEPS, ", ".join(
              "%s %.3f (%s)" % (k, ms[k], " ".join("%.3f" % t for t in v))
              for k, v in times.items()), amp_bound, amp_by, sum(conv_mm),
             nbytes, 100 * amp_bound / ms["AMP bf16"],
             bound_ms(*bound, False)[0], bound_ms(*bound, True)[0],
             busy_of(busy, ms["AMP bf16"]), top, card), flush=True)
    del amp_mod, amp_it, group
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the overflow drill: a poisoned third step under a loss scale
    drill_first = FirstStepWeights()
    with fault.inject(AMP_FAULT) as inj:
        mod, it = resnet_amp_fit(mt, seed, 2, args0, aux0, True,
                                 scale=AMP_SCALE, callbacks=[drill_first])
        drill_step = hold_first_step("AMP under loss scale %g" % AMP_SCALE,
                                     drill_first.w, f32_first, args0,
                                     ref_cos)
        group = mod._fused._group
        if group.loss_scale != AMP_SCALE:
            fail("ResNet-50 AMP: loss scale %s, want %g"
                 % (group.loss_scale, AMP_SCALE))
        before = written_tensors(group)
        fit_steps(mod, it, metric, steps=1)
        torch.cuda.synchronize()
        fired = inj.stats()[0][4]
    after = written_tensors(group)
    changed = [k for k in before if not torch.equal(before[k], after[k])]
    skips = group.amp_overflow_skips()
    if fired != 1 or changed or skips != 1:
        fail("ResNet-50 AMP overflow drill (%s, loss scale %g): fired %d, "
             "%d of %d written tensors changed by the poisoned step (%s), "
             "amp_overflow_skips() %d (want 1, none, 1)"
             % (AMP_FAULT, AMP_SCALE, fired, len(changed), len(before),
                changed[:4], skips))
    fit_steps(mod, it, metric, steps=1)
    final = written_tensors(group)
    moved = [k for k in before if k.startswith("w:")
             and not torch.equal(final[k], after[k])]
    finite = all(bool(torch.isfinite(final[k]).all()) for k in final
                 if k.startswith("w:"))
    if not moved or not finite:
        fail("ResNet-50 AMP overflow drill: the fourth step moved %d "
             "weights, finite %s" % (len(moved), finite))
    print("ResNet-50 AMP overflow drill (MXTPU_AMP_LOSS_SCALE=%g, %s): its "
          "first step %.4f of float32's in size at cosine %.4f (the limits "
          "above); the poisoned step left all %d written tensors (weights, "
          "momenta, BatchNorm statistics, t, the metric) bitwise as they "
          "were, amp_overflow_skips() = %d; the next step moved %d of %d "
          "weights, all finite; %s | %s"
          % (AMP_SCALE, AMP_FAULT, drill_step[0], drill_step[1],
             len(before), skips, len(moved), len(group.param_store),
             capture_report(mod, 4, "AMP drill")[0], card), flush=True)
    del mod, it, group, before, after, final
    gc.collect()
    torch.cuda.empty_cache()
    return ms


def bucket_times(mod, train, steps):
    """Host ms a captured step by bucket: ``steps`` steps on one batch of
    each bucket, the card waited for."""
    import torch
    train.reset()
    first = {}
    for batch in train:
        first.setdefault(batch.bucket_key, batch)
    out = {}
    for key, batch in sorted(first.items()):
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            mod.forward_backward(batch)
            mod.update()
        torch.cuda.synchronize()
        out[key] = (time.perf_counter() - t0) / steps * 1e3
    return out


def log_ppl_apart(got, want):
    """|log(got / want)| / log(want): two perplexities' cross-entropies
    apart, relative."""
    return abs(np.log(got / want)) / np.log(want)


def amp_lm_phase(mt, rnn_scan, sentences, rng, seed, card):
    """(c) The bucketed LM at PTB's widths through lstm_bucketing.py's
    BucketingModule.fit on phase 28's sentences and epochs from one Xavier
    draw, with MXTPU_AMP=bf16 and without: lstm_scan's nodes in each
    bucket's graph (their instantiation by name), its launches, the
    perplexity against float32's within AMP_PPL_SPREAD times the fit's
    spread (and the half-lr control outside it), ms a step by bucket, the
    kernel at the bucket-32 shape in the AMP graph's dtypes against its
    plain loop, timed in PAIRS interleaved pairs with cuDNN's bf16 LSTM.
    Returns (launches, {"amp"/"f32": {bucket: ms}}, the kernel's (ms,
    plain ms, cuDNN bf16 wall ms, max err, bound ms, wall ms, pairs the
    kernel won), labels)."""
    import gc
    import torch
    gpu = mt.gpu(0)
    with gpu:
        init, _it, _p = lstm_bucketing_fit(mt, sentences, RC_VOCAB, True,
                                           num_epoch=0)
    w0 = module_params(init)
    del init, _it
    # (label, weights, AMP, learning rate)
    runs = (("amp", w0, True, BL_LR), ("f32", w0, False, BL_LR),
            ("f32 ulp", ulp_apart(w0, seed), False, BL_LR),
            ("f32 U/2", bf16_apart(w0, seed), False, BL_LR),
            ("f32 U/2 b", bf16_apart(w0, seed + 1), False, BL_LR),
            ("amp ulp", ulp_apart(w0, seed), True, BL_LR),
            ("amp half lr", w0, True, BL_LR / 2))
    out, ppl, by_epoch, launches, labels = {}, {}, {}, None, {}
    for key, weights, amp, lr in runs:
        with env_set(MXTPU_AMP="bf16" if amp else "",
                     MXTPU_AMP_LOSS_SCALE=0):
            rnn_scan.reset_launches()
            with gpu:
                mod, train, ppls = lstm_bucketing_fit(
                    mt, sentences, RC_VOCAB, True, num_epoch=RC_EPOCHS,
                    arg_params=weights, lr=lr)
            torch.cuda.synchronize()
        ppl[key], by_epoch[key] = ppls[-1], ppls
        group = mod._buckets[mod._default_bucket_key]._fused._group
        if group.amp != ("bf16" if amp else None):
            fail("the bucketed LM (MXTPU_AMP=%s): AMP mode %s"
                 % ("bf16" if amp else "", group.amp))
        if key == "amp":
            report = bucket_graph_report(mt, mod, labels)
            launches = rnn_scan.LAUNCHES["lstm_scan"] + sum(
                r[2]["lstm"] * r[3] for r in report.values())
            bad = {k: v for k, v in labels.items()
                   if sum(v.values()) != BL_LAYERS or
                   any(" bf16/" not in " " + name for name in v)}
            if bad or len(labels) != len(report):
                fail("the AMP LM's graphs hold lstm_scan nodes %s (want %d "
                     "a bucket, of a bfloat16 x_proj)" % (labels, BL_LAYERS))
            dtypes = fused_store_dtypes(group)
            if any(d != {torch.float32} for d in dtypes.values()
                   if d):
                fail("the AMP LM's store holds %s" % dtypes)
        if key in ("amp", "f32"):
            out[key] = bucket_times(mod, train, AMP_BUCKET_STEPS)
        del mod, train, group
        gc.collect()
        torch.cuda.empty_cache()
    apart = {k: log_ppl_apart(ppl[k], ppl["f32"]) for k in ppl
             if k != "f32"}
    apart["amp ulp"] = log_ppl_apart(ppl["amp ulp"], ppl["amp"])
    spread = max(apart["f32 U/2"], apart["f32 U/2 b"], apart["amp ulp"])
    limit = AMP_PPL_SPREAD * spread
    print("bucketed LM at PTB's widths under AMP and in float32 from one "
          "Xavier draw (%d epochs over phase 28's %d sentences): "
          "perplexity by epoch %s; log perplexity relative apart from "
          "float32's %s (amp ulp: from amp's); the fit's spread at "
          "bfloat16's scale %.4g (the largest of f32 U/2, f32 U/2 b and amp "
          "ulp), AMP held within %g x it = %.4g, the half-lr control "
          "outside it | %s"
          % (RC_EPOCHS, len(sentences), "; ".join(
              "%s %s" % (k, ", ".join("%.3f" % v for v in by_epoch[k]))
              for k in by_epoch), ", ".join(
              "%s %.4g" % kv for kv in apart.items()), spread,
             AMP_PPL_SPREAD, limit, card), flush=True)
    if not apart["amp"] <= limit:
        fail("the bucketed LM: perplexity %.3f under AMP, %.3f in float32 "
             "(log perplexity %.3g relative apart, limit %g x the fit's "
             "spread %.3g)" % (ppl["amp"], ppl["f32"], apart["amp"],
                               AMP_PPL_SPREAD, spread))
    if not apart["amp half lr"] > limit:
        fail("the bucketed LM: the AMP fit at half the learning rate "
             "(perplexity %.3f, log perplexity %.3g relative apart) lies "
             "within the band %.3g, which therefore tells nothing"
             % (ppl["amp half lr"], apart["amp half lr"], limit))
    # the kernel at the bucket-32 shape in the AMP graph's dtypes
    x_dt, s_dt = (getattr(torch, {"bf16": "bfloat16", "f32": "float32"}[t])
                  for t in next(iter(labels[max(labels)])).split()[1]
                  .split("/"))
    T, N, H = max(BL_BUCKETS), BL_BATCH, BL_HIDDEN
    a = lstm_args(rng, N, torch.float32, gpu.torch_device(), T=T, H=H)
    a = [a[0].to(x_dt), a[1].to(s_dt), a[2].to(s_dt), a[3].to(x_dt)]
    got = rnn_scan.lstm_scan(*a)
    want = rnn_scan.lstm_scan_reference(*a)
    check_close("lstm_scan T=%d N=%d H=%d x %s, state %s (the AMP LM's)"
                % (T, N, H, x_dt, s_dt), got, want, BF16_TOL)
    err = max_err(got, want)
    plain_ms = cuda_ms(lambda: rnn_scan.lstm_scan_reference(*a), iters=5)
    # cuDNN's bf16 LSTM as phase 38 holds its f32 pair: held to the plain
    # loop on its own (bf16) inputs, then timed in PAIRS interleaved pairs
    # (the kernel's card time held, its wall time and cuDNN's wall time:
    # cuDNN blocks the host inside each call)
    b16 = [t.to(torch.bfloat16) for t in a]
    lib = cudnn_lstm(*b16)
    check_close("cuDNN's bf16 LSTM T=%d N=%d H=%d" % (T, N, H), list(lib()),
                list(rnn_scan.lstm_scan_reference(*b16)), BF16_TOL)
    lib_err = max_err(lib(), rnn_scan.lstm_scan_reference(*b16))
    pairs = [(held_ms(lambda: rnn_scan.lstm_scan(*a), iters=20),
              cuda_ms(lambda: rnn_scan.lstm_scan(*a), iters=20),
              cuda_ms(lib, iters=20)) for _ in range(PAIRS)]
    med = [float(np.median([p[i] for p in pairs])) for i in range(3)]
    wins = sum(p[1] < p[2] for p in pairs)
    k_bound = bound("lstm", N, itemsize=2, T=T, H=H)[0]
    plans = {b: rnn_scan.scan_plan("lstm", b, N, H, x_dt, s_dt)
             for b in BL_BUCKETS}
    print("bucketed LM at PTB's widths (vocabulary %d, %d x %d LSTM, batch "
          "%d, buckets %s), lstm_bucketing.py's fit, captured, under AMP: "
          "lstm_scan nodes a bucket graph "
          "%s, their plans (clusters of C CTAs x R rows, mode) %s; %d "
          "launches under AMP (warm-up + nodes x replays); ms a step "
          "by bucket AMP %s, float32 %s | %s"
          % (RC_VOCAB, BL_LAYERS, BL_HIDDEN, BL_BATCH, list(BL_BUCKETS),
             labels,
             {b: "%d x %d, %s" % (p.cluster, p.rows, p.mode)
              for b, p in plans.items()}, launches,
             {k: round(v, 3) for k, v in out["amp"].items()},
             {k: round(v, 3) for k, v in out["f32"].items()}, card),
          flush=True)
    print("time lstm_scan T=%d N=%d H=%d x %s state %s (the AMP LM's) pairs "
          "(kernel card ms held, kernel wall ms, cuDNN bf16 wall ms), in "
          "order: %s; medians: kernel %.5f ms card, %.5f wall (bound %.5f, "
          "plain loop %.4f), max err %.3g (BF16_TOL); cuDNN's bf16 LSTM "
          "%.5f wall (max |cuDNN - plain| %.3g, BF16_TOL); kernel faster "
          "in %d of %d | %s"
          % (T, N, H, x_dt, s_dt, " ".join("(%.5f, %.5f, %.5f)" % p
                                           for p in pairs),
             med[0], med[1], k_bound, plain_ms, err, med[2], lib_err, wins,
             PAIRS, card), flush=True)
    return launches, out, (med[0], plain_ms, med[2], err, k_bound, med[1],
                           wins), labels


def checkpoint_gluon_phase(mt, seed, workdir, card):
    """(d) CheckpointManager as documented, on Gluon's resnet18_v1 (224,
    batch 128, hybridized, SGD as phase 15's): two runs never stopped
    (CK_SAVE + CK_MORE steps), the first saving at CK_SAVE; a fresh net and
    Trainer restored from that step and stepped CK_MORE more. Returns the
    save's (host ms blocked, background write s, MB)."""
    import gc
    import torch
    from mxtpu_torch.checkpoint import CheckpointManager, weight_digest
    gpu = mt.gpu(0)
    x, y = gluon_images(seed + 7, GL_BATCH)
    w0 = gluon_weights(mt, gluon_resnet18(mt), seed, x[:2])
    xs, ys = mt.nd.array(x, ctx=gpu), mt.nd.array(y, ctx=gpu)
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    ckpt = CheckpointManager(os.path.join(workdir, "ckpt_gluon"),
                             max_to_keep=2)

    def build():
        net = gluon_load(mt, gluon_resnet18(mt), w0, gpu)
        net.hybridize()
        return net, mt.gluon.Trainer(net.collect_params(), "sgd",
                                     dict(GL_OPT))

    def steps(net, trainer, n):
        for _ in range(n):
            with mt.autograd.record():
                loss = loss_fn(net(xs), ys)
            loss.backward()
            trainer.step(GL_BATCH)

    saved = {}
    ends = []
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for run in range(2):
            net, trainer = build()
            steps(net, trainer, CK_SAVE)
            if run == 0:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ckpt.save(CK_SAVE, net.collect_params(), trainer=trainer,
                          metadata={"step": CK_SAVE})
                t1 = time.perf_counter()
                ckpt.wait_until_finished()
                t2 = time.perf_counter()
                saved = {"values": gluon_values(net),
                         "blocked": (t1 - t0) * 1e3, "write": t2 - t1}
            steps(net, trainer, CK_MORE)
            ends.append(gluon_values(net))
            del net, trainer
            gc.collect()
        net, trainer = build()
        tree = ckpt.restore(CK_SAVE, net.collect_params(), trainer=trainer)
        restored_at = gluon_values(net)
        steps(net, trainer, CK_MORE)
        resumed = gluon_values(net)
        del net, trainer
    finally:
        torch.backends.cudnn.deterministic = old
    gc.collect()
    torch.cuda.empty_cache()
    step_dir = os.path.join(ckpt.directory, "step_%d" % CK_SAVE)
    mb = sum(os.path.getsize(os.path.join(step_dir, f))
             for f in os.listdir(step_dir)) / 1e6
    card_digest = weight_digest(saved["values"])
    if ckpt.digest(CK_SAVE) != card_digest or \
            tree["metadata"] != {"step": CK_SAVE}:
        fail("CheckpointManager: the step's digest %s, the card's "
             "parameters' %s; metadata %s"
             % (ckpt.digest(CK_SAVE), card_digest, tree["metadata"]))
    if any(not np.array_equal(restored_at[k], saved["values"][k])
           for k in restored_at):
        fail("CheckpointManager: the restored net differs from the saved "
             "values")
    twin = all(np.array_equal(ends[0][k], ends[1][k]) for k in ends[0])
    if twin:
        apart = [k for k in resumed if not np.array_equal(resumed[k],
                                                           ends[0][k])]
        if apart:
            fail("CheckpointManager: %d arrays of the resumed run differ "
                 "from the runs never stopped, which agree bitwise (%s)"
                 % (len(apart), apart[:3]))
        how = "bitwise equal to them (the two never-stopped runs agree " \
              "bitwise)"
    else:
        worst = 0.0
        for k in resumed:
            spread = float(np.abs(ends[0][k] - ends[1][k]).max())
            d = max(float(np.abs(resumed[k] - e[k]).max()) for e in ends)
            if d > spread:
                fail("CheckpointManager: resumed %s %.3g from the runs never "
                     "stopped, which differ by %.3g" % (k, d, spread))
            worst = max(worst, d)
        how = "within the spread of the two never-stopped runs (largest " \
              "%.3g)" % worst
    print("CheckpointManager (resnet18_v1, 224^2, batch %d, hybridized, "
          "SGD): saved at step %d with its Trainer, the file's weight_digest "
          "equals the card's parameters' read back; restored into a fresh "
          "net and Trainer, %d more steps %s; save blocked the loop %.1f ms "
          "(the copy to the host), the background write took %.3f s, the "
          "step holds %.1f MB | %s"
          % (GL_BATCH, CK_SAVE, CK_MORE, how, saved["blocked"],
             saved["write"], mb, card), flush=True)
    return saved["blocked"], saved["write"], mb


def legacy_params_phase(mt, seed, w0, workdir, card):
    """(e) ResNet-50's arguments and aux states (phase 26's MSRAPrelu
    draws from ``seed``) written in MXNet's binary .params format and as
    the port's .npz checkpoint, each loaded through Module.load: the
    forward on the card from the two is bitwise equal."""
    import torch
    from mxtpu_torch import legacy_params
    args0, aux0 = w0
    sym = resnet_symbol(mt, 50, RN_SHAPE, RN_CLASSES)
    legacy, npz = (os.path.join(workdir, n) for n in ("legacy", "npz"))
    sym.save("%s-symbol.json" % legacy)
    entries = {"arg:" + k: v for k, v in args0.items()}
    entries.update(("aux:" + k, v) for k, v in aux0.items())
    legacy_params.save_legacy_params("%s-0000.params" % legacy, entries)
    with open("%s-0000.params" % legacy, "rb") as f:
        if not legacy_params.is_legacy_params(f.read(8)):
            fail("save_legacy_params wrote no 0x112 magic")
    mt.model.save_checkpoint(npz, 0, sym, mt.model.params_from_numpy(
        args0, aux0, mt.cpu())[0], mt.model.params_from_numpy(
            args0, aux0, mt.cpu())[1])
    dims = tuple(int(v) for v in RN_SHAPE.split(","))
    x = np.random.RandomState(seed).uniform(
        -1, 1, (RN_CHECK_BATCH,) + dims).astype(np.float32)
    outs = []
    for prefix in (legacy, npz):
        mod = mt.mod.Module.load(prefix, 0, context=mt.gpu(0))
        mod.bind([("data", x.shape)], [("softmax_label", (len(x),))],
                 for_training=False)
        mod.forward(mt.io.DataBatch([mt.nd.array(x)], []), is_train=False)
        outs.append(mod.get_outputs()[0].data.clone())
        del mod
    if not torch.equal(*outs):
        fail("ResNet-50 from MXNet's .params and from .npz: forwards differ "
             "by %.3g" % max_err(outs[0], outs[1]))
    print("MXNet's binary .params at ResNet-50's width (%d arrays, %.1f MB, "
          "uint32 dims) through Module.load: the forward of %d images on "
          "the card bitwise equal to the .npz checkpoint's | %s"
          % (len(entries), os.path.getsize("%s-0000.params" % legacy) / 1e6,
             len(x), card), flush=True)


def float16_phase(mt, seed, card):
    """(f) train_imagenet.py --dtype float16: symbols/resnet.py's float16
    ResNet-50 (Cast in, Cast out), SyntheticDataIter's float16 batch, fit's
    multi_precision SGD, F16_STEPS captured steps: the float16 weights the
    graph's types give, each equal to its float32 master rounded, and ms a
    step. Returns ms a step."""
    import gc
    import torch
    gpu = mt.gpu(0)
    np.random.seed(seed)
    mt.random.seed(seed)
    sym = resnet_symbol(mt, 50, RN_SHAPE, RN_CLASSES, dtype="float16")
    shape = (RN_BATCH,) + tuple(int(v) for v in RN_SHAPE.split(","))
    train = synthetic_data_iter(mt, RN_CLASSES, shape, F16_STEPS,
                                dtype="float16")
    a = IMAGENET_ARGS
    mod = fit_call(mt, sym, train, None, "local", 1, a["lr"], None, a["mom"],
                   a["wd"], RN_BATCH, a["disp_batches"], context=gpu)
    text = capture_report(mod, F16_STEPS, "ResNet-50 float16")[0]
    group = mod._fused._group
    exec_ = mod._exec_group.execs[0]
    kinds = {}
    halves = 0
    for slot, name in zip(mod._fused._opt_slots, mod._fused._train_names):
        w = exec_.arg_dict[name]._data
        kinds.setdefault(str(w.dtype), []).append(name)
        if w.dtype == torch.float16:
            master = group.states[slot][0].data
            if master.dtype != torch.float32 or \
                    not torch.equal(master.half(), w):
                fail("--dtype float16: %s is not its float32 master "
                     "rounded (master %s)" % (name, master.dtype))
            halves += 1
    if not halves:
        fail("--dtype float16 bound no float16 weight: %s"
             % {k: len(v) for k, v in kinds.items()})
    metric = mt.metric.create([mt.metric.create("accuracy")])
    ms = timed_steps(mod, train, metric, F16_STEPS)
    print("train_imagenet.py --dtype float16 (ResNet-50, 224^2, batch %d, "
          "multi_precision SGD, captured): %s; weights by dtype %s, each "
          "float16 one equal to its float32 master rounded; %.3f ms a step "
          "(%d steps) | %s"
          % (RN_BATCH, text, {k: len(v) for k, v in kinds.items()}, ms,
             F16_STEPS, card), flush=True)
    del mod, train, group, exec_
    gc.collect()
    torch.cuda.empty_cache()
    return ms


def durability_phase(mt, rnn_scan, seed, w0, bound, sentences, rng,
                     workdir, card):
    """Phase 37 (ROADMAP A10): (a)-(f) above. Returns what the result
    lines print."""
    import gc
    import torch
    t_phase = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    print("durability and precision phase: the card holds %.2f GB "
          "allocated, %.2f GB reserved at its start"
          % (torch.cuda.memory_allocated() / 1e9,
             torch.cuda.memory_reserved() / 1e9), flush=True)
    clock = [("start", time.perf_counter())]
    out = {"resnet": resnet_amp_phase(mt, seed, card, w0, bound)}
    clock.append(("ResNet-50 AMP and drill", time.perf_counter()))
    out["lm"] = amp_lm_phase(mt, rnn_scan, sentences, rng, seed, card)
    clock.append(("LM", time.perf_counter()))
    out["ckpt"] = checkpoint_gluon_phase(mt, seed, workdir, card)
    clock.append(("CheckpointManager", time.perf_counter()))
    legacy_params_phase(mt, seed, w0, workdir, card)
    clock.append(("legacy .params", time.perf_counter()))
    out["f16"] = float16_phase(mt, seed, card)
    clock.append(("float16", time.perf_counter()))
    print("durability and precision phase: %.1f s (%s)" % (
        time.time() - t_phase, ", ".join(
            "%s %.1f" % (name, t - clock[i][1])
            for i, (name, t) in enumerate(clock[1:]))), flush=True)
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one card")
    sys.path.insert(0, ROOT)
    try:
        import mxtpu_torch as mt
        from mxtpu_torch import _build
        from mxtpu_torch.ops import rnn_scan
        from mxtpu_torch.ops import flash_attention as fa
    except ImportError as e:
        fail("the mxtpu_torch package is not beside this script (%s)" % e)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.time()

    # 1. the card
    card = card_line()
    print("device: %s | nvidia-smi: %s" % (torch.cuda.get_device_name(0),
                                           card))
    print("torch %s, CUDA %s" % (torch.__version__, torch.version.cuda))

    # 2. build
    t0 = time.time()
    _build.build_all()
    print("kernels built in %.1f s into %s" % (time.time() - t0,
                                                _build.build_dir()))
    for name in _build.SOURCES:
        for line in _build.build_log.get(name, "").splitlines():
            if "entry function" in line or "registers" in line or \
                    "spill stores" in line:
                print("  ptxas %s: %s" % (name, line.strip()))
    # the bf16 dK/dV kernel holds the most registers: its cost by head dim
    dkv = sorted((int(re.search(r"ILi(\d+)E", e).group(1)), r)
                 for e, r in ptxas_report(_build.build_log.get(
                     "flash_attention_sm90", "")).items()
                 if "dkv_sm90_kernel" in e)
    print("ptxas dkv_sm90_kernel (registers, spill store / load bytes) by "
          "head dim: %s" % ("; ".join(
              "D=%d %d, %d / %d" % ((d,) + r) for d, r in dkv)
              or "not built in this process (library found built)"))
    # the f32 kernels at D=16 and 32 (the lane split; the backward must
    # not spill there) and at D=128 (where the tile loader spills)
    f32 = sorted((int(re.search(r"ILi(\d+)E", e).group(1)),
                  re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv))_kernel",
                            e).group(1), r)
                 for e, r in ptxas_report(_build.build_log.get(
                     "flash_attention", "")).items()
                 if re.search(r"ILi(16|32|128)E", e))
    print("ptxas f32 flash kernels (registers, spill store / load bytes): "
          "%s" % ("; ".join("D=%d %s %d, %d / %d" % ((d, n) + r)
                            for d, n, r in f32)
                  or "not built in this process (library found built)"))
    # the LSTM/GRU cluster kernels, one a (kind, x/state dtypes, rows)
    rnn = sorted((rnn_kernel_label(e), r) for e, r in ptxas_report(
        _build.build_log.get("rnn_scan", "")).items() if rnn_kernel_label(e))
    print("ptxas rnn_cluster_kernel (registers, spill store / load bytes): "
          "%s" % ("; ".join("%s %d, %d / %d" % ((n,) + r) for n, r in rnn)
                  or "not built in this process (library found built)"))
    spilled = ["D=%d %s" % (d, n) for d, n, r in f32
               if d <= 32 and "bwd" in n and r[1:] != (0, 0)]
    if spilled:
        fail("the f32 backward spills at %s" % ", ".join(spilled))

    # 3. kernels against their plain versions
    rng = np.random.RandomState(args.seed)
    errs = rnn_kernel_phase(rnn_scan, rng, dev)
    # flash attention: the training slice's shape, the JAX package's check
    # shape, shard offsets that leave rows 0..63 fully masked (and a
    # partly visible key block), and lengths off the 64-row tile
    slice_shape = (LM_BATCH, LM_HEADS, LM_SEQ, LM_SEQ, LM_DIM // LM_HEADS)
    flash_errs, slice_in = check_flash(fa, rng, dev, *slice_shape,
                                       torch.float32, FLASH_F32_TOL)
    errs.update(flash_errs)
    # (bf16 runs on the sm90 kernels; their errors are the largest over
    # every bf16 case)
    sm90_errs = {"flash_fwd_sm90": 0.0, "flash_bwd_dq_sm90": 0.0,
                 "flash_bwd_dkv_sm90": 0.0}

    def check_bf16(*shape, **offsets):
        e, a = check_flash(fa, rng, dev, *shape, torch.bfloat16,
                           FLASH_BF16_TOL, **offsets)
        for name in sm90_errs:
            sm90_errs[name] = max(sm90_errs[name], e[name])
        return a
    long_in = {D: check_bf16(1, 8, 8192, 8192, D) for D in (64, 128)}
    masked = [check_flash(fa, rng, dev, 1, 2, 128, 128, D, torch.float32,
                          FLASH_F32_TOL, q_off=0, k_off=64)[1]
              for D in (16, 32, 128)]
    masked += [check_bf16(1, 2, 128, 128, D, q_off=0, k_off=64)
               for D in (16, 32)]
    for m in masked:
        o, lse = fa.flash_fwd(m["q"], m["k"], m["v"], m["offs"], True)
        if o[:, :64].abs().max() != 0 or \
                not bool((lse[:, :64] == -1e30).all()):
            fail("fully-masked rows must give O = 0 and lse = -1e30 (%s, "
                 "D=%d)" % (o.dtype, o.shape[-1]))
        bw = (m["q"], m["k"], m["v"], m["do"], m["lse"], m["delta"],
              m["offs"], True)
        dk, dv = fa.flash_bwd_dkv(*bw)
        if dk[:, 64:].abs().max() != 0 or dv[:, 64:].abs().max() != 0:
            fail("keys no query sees must get dK = dV = 0 (%s, D=%d)"
                 % (dk.dtype, dk.shape[-1]))
    for D in (16, 32, 64, 128):
        check_flash(fa, rng, dev, 1, 2, 128, 200, D, torch.float32,
                    FLASH_F32_TOL, q_off=150, k_off=20)
    for D in (16, 32, 128):
        check_flash(fa, rng, dev, 2, 3, 100, 72, D, torch.float32,
                    FLASH_F32_TOL)
    # the edges of the lane split at D <= 32: keys past kv_len < Tk, Tq
    # and Tk off the 32-row tile with a shard offset that puts the causal
    # limit inside a tile
    for D in (16, 32):
        check_flash(fa, rng, dev, 1, 2, 96, 128, D, torch.float32,
                    FLASH_F32_TOL, kv_len=77)
        check_flash(fa, rng, dev, 1, 2, 90, 110, D, torch.float32,
                    FLASH_F32_TOL, q_off=40, k_off=13)
    for D in (16, 32):
        check_bf16(2, 3, 100, 72, D)
    # the RNN kernels under autograd: gradients against the CPU, one
    # launch a forward, none a backward
    rnn_grad_phase(rnn_scan, rng, dev)

    # 4.-5. serving: the LSTM LM, then its GRU variant
    workdir = os.path.join(_build.build_dir(), "smoke")
    os.makedirs(workdir, exist_ok=True)
    engine, launches = serve(mt, rnn_scan, "lstm", args.seed, REQUEST_ROWS,
                             workdir)
    if launches["lstm_scan"] != LAYERS * len(REQUEST_ROWS):
        fail("lstm_scan launched %d times for %d requests of a %d-layer LM"
             % (launches["lstm_scan"], len(REQUEST_ROWS), LAYERS))
    _gru_engine, gru_launches = serve(mt, rnn_scan, "gru", args.seed,
                                      GRU_REQUEST_ROWS, workdir)
    if gru_launches["gru_scan"] != LAYERS * len(GRU_REQUEST_ROWS):
        fail("gru_scan launched %d times for %d requests of a %d-layer LM"
             % (gru_launches["gru_scan"], len(GRU_REQUEST_ROWS), LAYERS))
    path_launches = {"lstm_scan": launches["lstm_scan"],
                     "gru_scan": gru_launches["gru_scan"]}

    # 6. training: the attention LM, 300 steps on the card
    params0 = lm_init_params(args.seed)
    batch_rng = np.random.RandomState(args.seed + 3)
    batches = [lm_batch(batch_rng, LM_BATCH) for _ in range(LM_STEPS)]
    cpu = torch.device("cpu")
    cpu_p, cpu_losses = lm_train(
        params0, [torch.from_numpy(b) for b in batches[:3]], cpu,
        impl="flash")
    gpu_batches = [torch.from_numpy(b).to(dev) for b in batches]
    gpu_p3, gpu_losses3 = lm_train(params0, gpu_batches[:3], dev)
    check_close("LM losses of steps 1-3, card vs CPU", [gpu_losses3.cpu()],
                [cpu_losses], LM_TOL)
    check_close("LM params after 3 steps, card vs CPU",
                [gpu_p3[k].cpu() for k in LM_PARAMS],
                [cpu_p[k] for k in LM_PARAMS], LM_TOL)
    lm_err = max(max_err([gpu_losses3.cpu()], [cpu_losses]),
                 max_err([gpu_p3[k].cpu() for k in LM_PARAMS],
                         [cpu_p[k] for k in LM_PARAMS]))
    print("slice train: steps 1-3 on the card vs the CPU (plain path): "
          "losses %s vs %s, max |card - cpu| over losses and params %.3g"
          % (["%.6f" % x for x in gpu_losses3.tolist()],
             ["%.6f" % x for x in cpu_losses.tolist()], lm_err))
    fa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _p, losses = lm_train(params0, gpu_batches, dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    flash_launches = {k: fa.LAUNCHES[k] for k in
                      ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    losses = losses.cpu().numpy()
    path_launches.update(flash_launches)
    for name, n in flash_launches.items():
        if n != LM_STEPS:
            fail("%s launched %d times in %d training steps, want one a "
                 "step" % (name, n, LM_STEPS))
    if not np.isfinite(losses).all() or \
            losses[-1] >= 0.5 * np.log(LM_VOCAB):
        fail("the LM did not learn to copy: final nll %.4f (limit %.4f)"
             % (losses[-1], 0.5 * np.log(LM_VOCAB)))
    print("slice train: %d steps on %s in %.2f s, nll %s -> final %.4f "
          "(limit 0.5 ln %d = %.4f), launches %s"
          % (LM_STEPS, dev, train_s, ", ".join(
              "%d: %.4f" % (i, losses[i]) for i in range(0, LM_STEPS, 50)),
             losses[-1], LM_VOCAB, 0.5 * np.log(LM_VOCAB), flash_launches))

    # 7. the op entry: nd.flash_attention on the card
    q, k, v = (mt.nd.array(rng.standard_normal((2, 4, 128, 32)).astype(
        np.float32), ctx=mt.gpu(0)) for _ in range(3))
    fa.reset_launches()
    out = mt.nd.flash_attention(q, k, v, causal=True)
    if fa.LAUNCHES["flash_fwd"] != 1:
        fail("nd.flash_attention on the card launched flash_fwd %d times"
             % fa.LAUNCHES["flash_fwd"])
    want = fa.flash_attention_reference(q.data, k.data, v.data, causal=True)
    check_close("nd.flash_attention", [out.data], [want], FLASH_F32_TOL)
    print("op entry: nd.flash_attention on %s launched flash_fwd once, max "
          "|out - reference| %.3g" % (out.context,
                                       max_err([out.data], [want])))

    # local_attention(impl="auto") routes by what the kernels take; the
    # SoftmaxOutput head's backward on the card
    attention_route_phase(fa, rng, dev)
    softmax_output_phase(mt)

    # 8. the bf16 long-context path through the public entries: the op on
    # (1, 8, 8192, 64) NDArrays launches the sm90 forward alone, and
    # local_attention(impl="auto") forward and backward on (1, 8, 8192,
    # 128) launches the sm90 forward, dQ and dK/dV once each; every output
    # against the plain versions
    bf16_path, long_fwd_bwd = bf16_long_context(mt, fa, rng, dev)

    # 9. mx.rtc: the launch protocol on cuda:0
    gpu = mt.gpu(0)
    rtc_mod = rtc_phase(mt)

    # 10. the custom-op slice: the head's kernels against their plain
    # versions, at the slice's shape and at the LM's output rows
    cs_register(mt)
    ck = cs_kernels()
    cs_errs, cs_in = {}, {}
    for shape in ((CS_BATCH, CS_CLASSES), CS_BIG):
        xg = mt.nd.array(rng.standard_normal(shape).astype(np.float32) * 3,
                         ctx=gpu)
        yg = mt.nd.empty(shape, ctx=gpu)
        label = mt.nd.array(rng.randint(0, shape[1], shape[0]).astype(
            np.float32), ctx=gpu)
        dx = mt.nd.empty(shape, ctx=gpu)
        cs_softmax_fwd(xg, yg)
        cs_softmax_bwd(yg, label, dx)
        torch.cuda.synchronize()
        got = {"cs_softmax_fwd": yg.data, "cs_softmax_bwd": dx.data}
        want = {"cs_softmax_fwd": cs_softmax_fwd_plain(xg.data),
                "cs_softmax_bwd": cs_softmax_bwd_plain(yg.data, label.data)}
        for name in CS_SIGNATURES:
            check_close("%s %s" % (name, shape), [got[name]], [want[name]],
                        CS_KERNEL_TOL)
            if shape == (CS_BATCH, CS_CLASSES):
                cs_errs[name] = max_err([got[name]], [want[name]])
        cs_in[shape] = (xg, yg, label, dx)
        print("check %s at %s: max err %s (tolerance %s)"
              % (list(CS_SIGNATURES), shape,
                 ["%.3g" % max_err([got[n]], [want[n]])
                  for n in CS_SIGNATURES], CS_KERNEL_TOL))
    # the forward's other widths and alignments: one lane a row, a full
    # warp a row, the held path at a warp and with rows off the 16-byte
    # boundary (x's view offset by one float, so y's rows sit off x's
    # alignment), and the two-pass loop past 32,768 columns
    for shape, offset in (((33, 1), 0), ((9, 32), 0), ((5, 33), 0),
                          ((37, 1001), 0), ((37, 1001), 1),
                          ((3, 40000), 0)):
        flat = torch.from_numpy(rng.standard_normal(
            shape[0] * shape[1] + offset).astype(np.float32) * 3).to(dev)
        xg = mt.nd.NDArray(flat[offset:].view(shape), gpu)
        yg = mt.nd.empty(shape, ctx=gpu)
        cs_softmax_fwd(xg, yg)
        torch.cuda.synchronize()
        want = cs_softmax_fwd_plain(xg.data)
        check_close("cs_softmax_fwd %s, x offset %d floats" % (shape, offset),
                    [yg.data], [want], CS_KERNEL_TOL)
        print("check cs_softmax_fwd %s, x offset %d floats (grid, block) %s: "
              "max err %.3g" % (shape, offset, cs_softmax_fwd_dims(*shape),
                                max_err([yg.data], [want])))
    print("cs_softmax_fwd on the card: %d registers, %d bytes of local "
          "memory a thread (CS_VEC %d)" % (cu_func_attrs(
              cs_module()._function("cs_softmax_fwd", 0)) + (CS_VEC,)))

    # the MLP trained 64 steps on cuda:0, its first 3 steps against the
    # CPU's plain route
    x_all, y_all = cs_data()
    cs_p0 = cs_init_params(args.seed)
    cs_b = cs_batches(args.seed)
    xs_cpu, ys_cpu = mt.nd.array(x_all, ctx=mt.cpu()), \
        mt.nd.array(y_all, ctx=mt.cpu())
    xs, ys = xs_cpu.as_in_context(gpu), ys_cpu.as_in_context(gpu)
    cpu_params, cpu_cs_losses = cs_train(mt, cs_p0, xs_cpu, ys_cpu,
                                         cs_b[:3])
    gpu_params3, gpu_cs_losses3 = cs_train(mt, cs_p0, xs, ys, cs_b[:3])
    names = sorted(cs_p0)
    check_close("MLP losses of steps 1-3, card vs CPU",
                [gpu_cs_losses3.cpu()], [cpu_cs_losses], CS_TOL)
    check_close("MLP params after 3 steps, card vs CPU",
                [gpu_params3[k].data.detach().cpu() for k in names],
                [cpu_params[k].data.detach() for k in names], CS_TOL)
    cs_err3 = max(max_err([gpu_cs_losses3.cpu()], [cpu_cs_losses]),
                  max_err([gpu_params3[k].data.detach().cpu()
                           for k in names],
                          [cpu_params[k].data.detach() for k in names]))
    print("slice custom-op: steps 1-3 on the card vs the CPU (plain route): "
          "losses %s vs %s, max |card - cpu| over losses and params %.3g"
          % (["%.6f" % v for v in gpu_cs_losses3.tolist()],
             ["%.6f" % v for v in cpu_cs_losses.tolist()], cs_err3))
    for kern in ck.values():
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs_params, cs_losses = cs_train(mt, cs_p0, xs, ys, cs_b)
    torch.cuda.synchronize()
    cs_train_s = time.perf_counter() - t0
    cs_launches = {n: kern.launches for n, kern in ck.items()}
    for name, n in cs_launches.items():
        if n != CS_STEPS:
            fail("%s launched %d times in %d training steps, want one a "
                 "step" % (name, n, CS_STEPS))
    cs_acc = cs_accuracy(mt, cs_params, xs, y_all)
    cs_losses = cs_losses.cpu().numpy()
    if not np.isfinite(cs_losses).all() or cs_acc <= 0.9:
        fail("the custom-softmax MLP did not learn: train accuracy %.4f "
             "(limit 0.9), final loss %.4f" % (cs_acc, cs_losses[-1]))
    print("slice custom-op train: %d steps on %s in %.3f s, loss %s -> "
          "final %.3g, train accuracy %.4f (limit 0.9), launches %s"
          % (CS_STEPS, xs.context, cs_train_s, ", ".join(
              "%d: %.4f" % (i, cs_losses[i]) for i in range(0, CS_STEPS, 16)),
             cs_losses[-1], cs_acc, cs_launches))

    # served on cuda:0 with buckets 1-128, against the same weights on
    # the CPU
    cs_sym = cs_symbol(mt)
    trained = {k: p.detach() for k, p in cs_params.items()}
    cs_kw = dict(data_shapes={"data": (CS_IN,)}, buckets=CS_BUCKETS)
    cs_engine = mt.serving.InferenceEngine(cs_sym, trained, {}, ctx=gpu,
                                           **cs_kw)
    cs_cpu_engine = mt.serving.InferenceEngine(
        cs_sym, {k: p.asnumpy() for k, p in trained.items()}, {},
        ctx=mt.cpu(), **cs_kw)
    req_rng = np.random.RandomState(args.seed + 4)
    cs_requests = [x_all[req_rng.randint(0, CS_SAMPLES, r)]
                   for r in CS_REQUEST_ROWS]
    ck["cs_softmax_fwd"].launches = 0
    cs_answers = [cs_engine.predict([r])[0] for r in cs_requests]
    served_launches = ck["cs_softmax_fwd"].launches
    if served_launches != len(cs_requests):
        fail("cs_softmax_fwd launched %d times for %d requests"
             % (served_launches, len(cs_requests)))
    worst = 0.0
    for req, got in zip(cs_requests, cs_answers):
        want = cs_cpu_engine.predict([req])[0]
        if got.shape != (req.shape[0], CS_CLASSES) or \
                not np.isfinite(got).all() or \
                not np.allclose(got.sum(1), 1.0, atol=1e-5):
            fail("served answer has shape %s or is not a distribution"
                 % (got.shape,))
        if not np.allclose(got, want, **CS_SERVE_TOL):
            fail("custom-op MLP on the card differs from the CPU by %g"
                 % float(np.abs(got - want).max()))
        worst = max(worst, float(np.abs(got - want).max()))
    print("slice custom-op serve: %d requests (rows %s) on %s, max |card - "
          "cpu| = %.3g (tolerance %s), cs_softmax_fwd launched %d times"
          % (len(cs_requests), list(CS_REQUEST_ROWS), cs_engine.device,
             worst, CS_SERVE_TOL, served_launches))

    # 11. Module.fit with the eager step: the MLP (its head kernels every
    # step) and LeNet
    eager_fits = with_fused(False, module_fit_phase, mt, args.seed, workdir)

    # 12. Module.fit captured: one CUDA graph a batch signature (the main
    # path, which the head kernels' launches are counted on), then its step
    # beside the eager one
    fit_launches, captured_fits = fused_fit_phase(mt, args.seed, eager_fits)
    fit_step_ms = fit_times(mt, eager_fits, captured_fits, card)

    # 13. the bucketed LSTM LM through BucketingModule.fit (the main path
    # the time-loop kernels' launches are counted on): one graph a bucket
    # over one parameter store, lstm_scan (and in its GRU variant gru_scan)
    # inside each
    bl_launches, bl_errs = bucketed_lm_phase(mt, rnn_scan, rng, dev, card)
    path_launches.update(bl_launches)
    for name, err in bl_errs.items():
        errs[name] = max(errs[name], err)

    # 14. the ResNet slice: train_imagenet.py --benchmark 1's fit call,
    # ResNet-50 at full width eager and captured (BatchNorm's moving
    # statistics inside the captured step), then Inception-BN
    resnet_ms, resnet_bound = resnet_phase(mt, args.seed, card)

    # 15. the Gluon slice: ResNet-18 v1 through autograd.record / backward /
    # Trainer.step, eager and hybridized (one captured forward and backward
    # a signature); the Gluon word LM (the second path B4's and B5's
    # launches are counted on, from 0 just before each run); the MLP
    gluon_ms, gl_launches = gluon_phase(mt, rnn_scan, args.seed, card)

    # 16. the CIFAR records slice: train_cifar10.py --synthetic's fit call,
    # ResNet-110 fed by ImageRecordIter's decode pool, eager and captured
    cifar_ms = cifar_phase(mt, args.seed, card)

    # 17. the SSD slice: multibox_nms against its plain version, the
    # MultiBox ops against the CPU, then train_ssd_toy.py's main and SSD-300
    # from JPEG records (multibox_nms counted from 0 just before them)
    ssd_ms, nms_launches, nms_err, nms_timing = ssd_phase(mt, args.seed, card)

    # 18. the R-CNN toy: an RPN Group trained through simple_bind, then
    # Proposal on multibox_nms (counted from 0 just before it); 18b.
    # Proposal at Faster R-CNN's size, multibox_nms timed there
    from mxtpu_torch.ops import vision
    t_phase = time.time()
    rcnn_launches = rcnn_phase(mt, vision, card)
    proposal_timing = proposal_size_phase(mt, vision, rng, card)
    print("R-CNN phase: %.1f s" % (time.time() - t_phase), flush=True)

    # 19. multi-output graphs through Module.fit: multiple_outputs.py and
    # the multitask net, eager and fused
    t_phase = time.time()
    multitask_ms = multi_output_phase(mt, args.seed, card)
    print("multi-output phase: %.1f s" % (time.time() - t_phase), flush=True)

    # 20. the data files at MNIST's published size
    files_ms, paces, mnist_images = data_files_phase(mt, args.seed, card)

    # 21. every registered op on the card against the CPU; box_nms on the
    # NMS kernel (its launches counted from 0 over its checks)
    _n_ops, box_nms_timing = op_sweep_phase(mt, card)

    # 22. the examples the op sweep's ops open, each main on gpu(0)
    t_phase = time.time()
    examples_phase(mt, card)
    print("examples phase: %.1f s" % (time.time() - t_phase), flush=True)

    # 23. FCN-8s on VGG16 at full width through Module.fit
    fcn_ms = fcn8s_phase(mt, args.seed, card)

    # 24. the examples cached_attention and moe_ffn open, at their widths
    t_phase = time.time()
    a7_phase(mt, card)
    print("A7 examples phase: %.1f s" % (time.time() - t_phase), flush=True)

    # 25. the ALiBi LM at WikiText-103 widths served and trained, and
    # moe_ffn at Switch-Base-8's
    wt_phase(mt, args.seed, card)

    # 26. fit.py's --optimizer nag --initializer msra --top-k 5 --loss
    # ce,nll at ResNet-50's width, beside phase 14's captured SGD step
    ff_ms, resnet_w0 = fit_flags_phase(
        mt, args.seed, card, resnet_ms.get(("captured", "TF32 off")))

    # 27. every optimizer of the registry through LeNet's Module.fit,
    # captured against eager
    opt_routes = optimizer_sweep_phase(mt, args.seed, card)

    # 28. RNN checkpoints on the bucketed LM at PTB's widths (lstm_scan
    # counted from 0 just before its fit)
    rc_launches, rc_sentences = rnn_checkpoint_phase(mt, rnn_scan,
                                                     args.seed, card,
                                       workdir)

    # 29. SequentialModule, PythonLossModule and Monitor: the examples
    t_phase = time.time()
    module_examples_phase(mt, card)
    print("module examples phase: %.1f s" % (time.time() - t_phase),
          flush=True)

    # 30. the CTC examples: ctc_toy (lstm_scan) and deepspeech_toy
    # (gru_scan), counted from 0 just before each main
    t_phase = time.time()
    ctc_launches = ctc_examples_phase(mt, rnn_scan, card)
    print("CTC examples phase: %.1f s" % (time.time() - t_phase), flush=True)

    # 31. DeepSpeech 2 at its published widths through BucketingModule.fit
    # (gru_scan streamed at H=1760, counted from 0 just before the fit)
    ds2_launches, ds2_timing = ds2_phase(mt, rnn_scan, rng, dev, card)

    # 32. the Gluon cell stacks against the fused layers at PTB's widths
    # (B4 / B5 in the layers, counted from 0 just before each), contrib
    t_phase = time.time()
    cell_launches = gluon_cells_phase(mt, rnn_scan, args.seed, card)
    print("Gluon cells phase: %.1f s" % (time.time() - t_phase), flush=True)

    # 33. remat: resnet18_v1's stages, and the executor's mirror on LeNet
    remat_phase(mt, args.seed, card)

    # 34. the five Gluon examples no earlier phase ran (lstm_crf's
    # bidirectional LSTM: lstm_scan, counted from 0 just before its main)
    t_phase = time.time()
    gx_launches = gluon_examples_phase(mt, rnn_scan, card)
    print("Gluon examples phase: %.1f s" % (time.time() - t_phase),
          flush=True)

    # 35. what nd.random_normal opens: the VAE over phase 20's digits,
    # bbb_toy, draws in a captured block; deformable convolution at res5
    dense_ops_phase(mt, mnist_images, card)

    # 36. sparse arrays: the example's sparse logistic regression at
    # Avazu-app's width through Module.fit (CSR batches, a row-sparse
    # weight, lazy Adam), the example itself, SparseEmbedding at LM1B's
    # vocabulary
    sparse_av, sparse_se = sparse_phase(mt, args.seed, workdir, card)

    # 37. durability and precision: MXTPU_AMP=bf16 in the captured step on
    # ResNet-50 (phase 26's weights) with its overflow drill, and on the
    # bucketed LM over phase 28's sentences (lstm_scan in bfloat16,
    # counted from 0 just before its fit); CheckpointManager on Gluon's
    # resnet18_v1; MXNet's .params through Module.load; --dtype float16
    durable = durability_phase(mt, rnn_scan, args.seed, resnet_w0,
                               resnet_bound, rc_sentences, rng, workdir,
                               card)

    # 38. timings at the main paths' shapes
    N = BUCKETS[-1]
    kernels = []
    for name, make_args, plain, library, kind, replaces in (
            ("lstm_scan", lstm_args, rnn_scan.lstm_scan_reference,
             cudnn_lstm, "lstm", "mxtpu/ops/pallas_rnn.py:64"),
            ("gru_scan", gru_args, rnn_scan.gru_scan_reference,
             cudnn_gru, "gru", "mxtpu/ops/pallas_rnn.py:128")):
        kernel = getattr(rnn_scan, name)
        timing = {}
        for n in (N, 1):
            a = make_args(rng, n, torch.float32, dev)
            lib_call = library(*a)
            lib_err = max_err(lib_call(), plain(*a))
            # the kernel's card time by held_ms (its host cost a call is
            # close to its card time); cuDNN blocks the host inside each
            # call, so no sleep kernel can hold its launches: the pairs
            # compare wall time per call (events over back-to-back calls)
            # of both, in turns, and the kernel's card time rides beside
            pairs = [(held_ms(lambda: kernel(*a), iters=20),
                      cuda_ms(lambda: kernel(*a), iters=20),
                      cuda_ms(lib_call, iters=20)) for _ in range(PAIRS)]
            med = [float(np.median([p[i] for p in pairs])) for i in range(3)]
            wins = sum(p[1] < p[2] for p in pairs)
            timing[n] = (med, wins)
            plan = rnn_scan.scan_plan(kind, SEQ, n, HIDDEN, torch.float32,
                                      torch.float32)
            print("time %s T=%d N=%d H=%d f32 (clusters of %d x %d rows, "
                  "%s) pairs (kernel card ms held, kernel wall ms, cuDNN "
                  "wall ms), in order: %s; medians: kernel %.5f ms card "
                  "(%.3f us a step), %.5f wall; cuDNN %.5f wall (max "
                  "|cuDNN - plain| %.3g); kernel faster in %d of %d; "
                  "cuDNN's card time (profiler) %s | %s"
                  % (name, SEQ, n, HIDDEN, plan.cluster, plan.rows,
                     plan.mode, " ".join("(%.5f, %.5f, %.5f)" % p
                                         for p in pairs),
                     med[0], med[0] * 1e3 / SEQ, med[1], med[2], lib_err,
                     wins, PAIRS, prof_ms(lib_call, 5), card))
        a = make_args(rng, N, torch.float32, dev)
        plain_ms = cuda_ms(lambda: plain(*a), iters=10)
        bound_ms, bound_by = bound(kind, N)
        (med, wins), (med1, wins1) = timing[N], timing[1]
        print("time %s T=%d N=%d H=%d f32: kernel %.5f ms (card, held), "
              "plain %.4f ms, bound %.5f ms (%s), %.1f%% of bound, %d "
              "launches per request | %s"
              % (name, SEQ, N, HIDDEN, med[0], plain_ms, bound_ms, bound_by,
                 100 * bound_ms / med[0], LAYERS, card))
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mxtpu_torch/csrc/rnn_scan.cu",
            "replaces": replaces, "launches": path_launches[name],
            "launches_gluon_lm": gl_launches.get(name, 0),
            "launches_rnn_checkpoint": rc_launches.get(name, 0),
            "launches_ctc_examples": ctc_launches.get(name, 0),
            "launches_gluon_cells": cell_launches.get(name, 0),
            "launches_gluon_examples": gx_launches.get(name, 0),
            "launches_amp": durable["lm"][0] if name == "lstm_scan" else 0,
            "max_abs_err": errs[name], "ms": med[0], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": med[2], "wall_ms": med[1], "pairs": PAIRS,
            "library_wins": wins, "us_per_step": med[0] * 1e3 / SEQ,
            "ms_n1": med1[0], "wall_ms_n1": med1[1],
            "library_ms_n1": med1[2], "library_wins_n1": wins1})
        if name == "lstm_scan":
            (k_ms, k_plain, k_lib, k_err, k_bound, k_wall,
             k_wins) = durable["lm"][2]
            kernels[-1].update({
                "amp_shape": "T=%d N=%d H=%d bf16 x_proj, %s" % (
                    max(BL_BUCKETS), BL_BATCH, BL_HIDDEN, sorted(
                        {n for v in durable["lm"][3].values() for n in v})),
                "amp_ms": k_ms, "amp_plain_ms": k_plain,
                "amp_bound_ms": k_bound, "amp_library_ms": k_lib,
                "amp_wall_ms": k_wall, "amp_kernel_wins": k_wins,
                "amp_max_abs_err": k_err})
        if name == "gru_scan":
            kernels[-1].update({
                "launches_deepspeech2": ds2_launches,
                "ds2_shape": "T=%d N=%d H=%d f32" % (
                    ds2_frames(DS2["buckets"][0]), DS2["batch"],
                    DS2["hidden"]),
                "ds2_plan": ds2_timing["plan"], "ds2_ms": ds2_timing["ms"],
                "ds2_plain_ms": ds2_timing["plain_ms"],
                "ds2_bound_ms": ds2_timing["bound_ms"],
                "ds2_bound_by": ds2_timing["bound_by"],
                "ds2_library_ms": ds2_timing["library_ms"],
                "ds2_library_bidir_ms": ds2_timing["library_bidir_ms"],
                "ds2_max_abs_err": ds2_timing["max_abs_err"],
                "ctc_loss_ms": ds2_timing["ctc_ms"],
                "ctc_loss_library_ms": ds2_timing["ctc_library_ms"]})

    # the time loops under autograd: forward + backward beside cuDNN's
    rnn_train_times(rnn_scan, rng, dev, card)

    # flash kernels: the training slice's shape (f32; the JSON line) and
    # the JAX package's 8k check shape (bf16: the sm90 kernels, in the JSON
    # line at D=128); SDPA's backward is timed as forward+backward less
    # forward and stands for dQ and dK/dV together
    replaces = {"flash_fwd": "mxtpu/ops/pallas_attention.py:142",
                "flash_bwd_dq": "mxtpu/ops/pallas_attention.py:236",
                "flash_bwd_dkv": "mxtpu/ops/pallas_attention.py:255"}
    for label, a, (B, H, T, D), iters in (
            ("slice", slice_in, (LM_BATCH, LM_HEADS, LM_SEQ,
                                 LM_DIM // LM_HEADS), 50),
            ("8k d64", long_in[64], (1, 8, 8192, 64), 10),
            ("8k d128", long_in[128], (1, 8, 8192, 128), 10)):
        itemsize = a["q"].element_size()
        sdpa_fwd, sdpa_fwd_bwd = sdpa_calls(a, B, H)
        # at the slice's shape a launch takes less card time than the host
        # takes to enqueue it, so back-to-back events would time the host:
        # there the calls are enqueued behind a sleep kernel (held_ms; the
        # plain back-to-back events are printed beside it)
        small = label == "slice"

        def timed(fn, n):
            return held_ms(fn, iters=n) if small else cuda_ms(fn, iters=n)
        lib_fwd = timed(sdpa_fwd, iters)
        calls = flash_calls(fa, a)
        medians = {}
        if not small:
            lib_bwd = timed(sdpa_fwd_bwd, iters) - lib_fwd
        else:
            # the f32 backward (dQ + dK/dV) against SDPA's backward in
            # PAIRS interleaved pairs; the JSON line takes the medians
            pairs = [(held_ms(calls["flash_bwd_dq"][0], iters=iters),
                      held_ms(calls["flash_bwd_dkv"][0], iters=iters),
                      held_ms(sdpa_fwd_bwd, iters=iters)
                      - held_ms(sdpa_fwd, iters=iters))
                     for _ in range(PAIRS)]
            medians = {n: float(np.median([p[i] for p in pairs]))
                       for i, n in enumerate(("flash_bwd_dq",
                                              "flash_bwd_dkv"))}
            lib_bwd = float(np.median([p[2] for p in pairs]))
            ours = medians["flash_bwd_dq"] + medians["flash_bwd_dkv"]
            print("time flash_bwd_dq + flash_bwd_dkv slice pairs (dQ + dK/dV "
                  "ms, SDPA bwd ms; card time per call, events behind a "
                  "sleep), in order: %s; kernels faster in %d of %d; "
                  "medians dQ %.5f, dK/dV %.5f, sum %.5f, SDPA bwd %.5f, "
                  "ratio %.3f | %s"
                  % (" ".join("(%.5f, %.5f)" % (q + k, t)
                              for q, k, t in pairs),
                     sum(q + k < t for q, k, t in pairs), PAIRS,
                     medians["flash_bwd_dq"], medians["flash_bwd_dkv"], ours,
                     lib_bwd, ours / lib_bwd, card))
        for name, (kernel, plain) in calls.items():
            route = name + "_sm90" if a["q"].dtype == torch.bfloat16 \
                else name
            ms = medians[name] if name in medians else timed(kernel, iters)
            plain_ms = timed(plain, max(3, iters // 5))
            ms2 = timed(kernel, iters)
            lib_ms = lib_fwd if name == "flash_fwd" else lib_bwd
            bound_ms, bound_by = flash_bound(name, B * H, T, T, D, itemsize)
            print("time %s %s B=%d H=%d T=%d D=%d %s causal (%s): kernel "
                  "%.4f ms (again %.4f), plain %.4f ms, SDPA %s %.4f ms, "
                  "bound %.5f ms (%s), %.1f%% of bound%s | %s"
                  % (route, label, B, H, T, D, a["q"].dtype,
                     "card time per call, events behind a sleep" if small else
                     "events", ms, ms2, plain_ms,
                     "fwd" if name == "flash_fwd" else "bwd (dQ+dK/dV)",
                     lib_ms, bound_ms, bound_by, 100 * bound_ms / ms,
                     "; wall per call, events over %d back-to-back calls: "
                     "kernel %.4f ms; profiler's kernel time %s"
                     % (iters, cuda_ms(kernel, iters=iters),
                        prof_ms(kernel, iters)) if small else "", card))
            if label == "slice":
                kernels.append({
                    "name": name, "route": "cuda",
                    "source": "mxtpu_torch/csrc/flash_attention.cu",
                    "replaces": replaces[name],
                    "launches": path_launches[name],
                    "max_abs_err": errs[name], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": lib_ms})
            elif label == "8k d128" and route != name:
                kernels.append({
                    "name": route, "route": "cuda",
                    "source": "mxtpu_torch/csrc/flash_attention_sm90.cu",
                    "replaces": replaces[name],
                    "launches": bf16_path[route],
                    "max_abs_err": sm90_errs[route], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": lib_ms})

    # the bf16 long-context path end to end: local_attention forward and
    # backward at (1, 8, 8192, 128), and where its card time goes
    long_ms = cuda_ms(long_fwd_bwd, iters=5, warmup=2)
    busy, top = device_time(long_fwd_bwd, 3)
    print("bf16 long context: local_attention (1, %d, %d, 128) causal "
          "forward+backward %.3f ms (events over 5 calls), %s a call "
          "(profiler); per call: %s | %s"
          % (LONG_H, LONG_T, long_ms, busy_of(busy, long_ms), top, card))

    # the serving slice's throughput at bucket 32, host clock around whole
    # requests
    req = np.random.RandomState(args.seed + 2).randint(
        0, VOCAB, (N, SEQ)).astype(np.float32)
    for _ in range(3):
        engine.predict([req])
    torch.cuda.synchronize()
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.predict([req])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print("slice lstm bucket %d: %.2f requests/s, %.0f tokens scored/s "
          "(%.3f ms per request, numpy in and out) | %s"
          % (N, reps / dt, reps * N * SEQ / dt, dt / reps * 1e3, card))
    # where a request's time goes: the graph forward alone (tensors in and
    # out on the card), and the copy of its output to the host
    program = engine.program(N)
    params, aux, _version = engine._resolve_store(None)
    data = (torch.from_numpy(req).to(dev),)
    forward_ms = cuda_ms(lambda: program(data, params, aux), iters=reps)
    out = program(data, params, aux)[0]
    copy_ms = cuda_ms(lambda: out.cpu(), iters=reps)
    # the forward's card time: its launches queued behind a sleep kernel,
    # so the host's enqueueing leaves no gap on the card
    forward_card = held_ms(lambda: program(data, params, aux), iters=reps,
                           required=False)
    print("slice lstm bucket %d breakdown: graph forward %.3f ms (events), "
          "its card time %s (held), output copy to host (%.1f MB) %.3f ms, "
          "kernels %.3f ms (2 x lstm_scan) | %s"
          % (N, forward_ms, "not measured (the forward waits for the card)"
             if forward_card is None else "%.3f ms" % forward_card,
             out.numel() * 4 / 1e6, copy_ms, LAYERS * kernels[0]["ms"],
             card))
    busy, top = device_time(lambda: program(data, params, aux), 5)
    print("slice lstm bucket %d forward on the card (profiler): %s; top "
          "kernels (ms per forward): %s"
          % (N, busy_of(busy, forward_ms), top))

    # the training slice: ms per step and tokens/s (host clock around
    # whole steps ending in a synchronize), and where a step's device
    # time goes
    step_ms = train_s / LM_STEPS * 1e3
    print("slice train: %.3f ms per step over %d steps, %.0f tokens/s "
          "(batch %d x %d tokens) | %s"
          % (step_ms, LM_STEPS, LM_STEPS * LM_BATCH * LM_SEQ / train_s,
             LM_BATCH, LM_SEQ, card))
    few = gpu_batches[:10]
    busy, top = device_time(lambda: lm_train(params0, few, dev), 1,
                            per=len(few))
    print("slice train step on the card (profiler): %s per step; per "
          "step: %s" % (busy_of(busy, step_ms), top))

    # the custom-op slice: the head's kernels at the slice's shape (the
    # JSON line) and at the LM's output rows, beside their plain versions,
    # torch.softmax for the forward, and the bound; the backward
    # (y - onehot(label)) has no one-call PyTorch equivalent
    for label, shape in (("slice", (CS_BATCH, CS_CLASSES)),
                         ("LM rows", CS_BIG)):
        xg, yg, lab, dx = cs_in[shape]
        calls = {
            "cs_softmax_fwd": (lambda: cs_softmax_fwd(xg, yg),
                               lambda: cs_softmax_fwd_plain(xg.data),
                               lambda: torch.softmax(xg.data, 1)),
            "cs_softmax_bwd": (lambda: cs_softmax_bwd(yg, lab, dx),
                               lambda: cs_softmax_bwd_plain(yg.data,
                                                            lab.data),
                               None)}
        for name, (kernel, plain, library) in calls.items():
            # back-to-back launches at (128, 10) measure the host's launch
            # rate, not the card, so the card's own time comes from calls
            # enqueued behind a sleep kernel (held_ms); the event-timed
            # wall time per call is printed beside it. The kernel and
            # torch.softmax are timed in PAIRS interleaved pairs, and
            # each reports its median
            wall = {"kernel": cuda_ms(kernel), "plain": cuda_ms(plain),
                    "library": cuda_ms(library) if library else None}
            plain_ms = held_ms(plain)
            pairs = [(held_ms(kernel), held_ms(library) if library else None)
                     for _ in range(PAIRS)]
            ms = float(np.median([p[0] for p in pairs]))
            lib_ms = (float(np.median([p[1] for p in pairs])) if library
                      else None)
            bound_ms, bound_by = cs_bound(name, *shape)
            print("time %s %s %dx%d f32 (card time per call, events behind "
                  "a sleep; median of %d): kernel %.5f ms, plain %.5f ms, "
                  "library %s, bound %.3g ms (%s), %.1f%% of bound; wall per "
                  "call, events over 50 back-to-back calls: kernel %.4f ms, "
                  "plain %.4f ms%s; profiler's kernel time %s | %s"
                  % (name, label, shape[0], shape[1], PAIRS, ms, plain_ms,
                     "torch.softmax %.5f ms" % lib_ms if lib_ms is not None
                     else "none (no one-call torch equivalent of y - "
                     "onehot(label))", bound_ms, bound_by,
                     100 * bound_ms / ms, wall["kernel"], wall["plain"],
                     ", torch.softmax %.4f ms" % wall["library"]
                     if library else "", prof_ms(kernel, 20), card))
            if library:
                print("time %s %s %dx%d pairs (kernel ms, torch.softmax ms), "
                      "in order: %s; kernel faster in %d of %d, medians' "
                      "ratio %.3f"
                      % (name, label, shape[0], shape[1],
                         " ".join("(%.5f, %.5f)" % p for p in pairs),
                         sum(k < t for k, t in pairs), PAIRS,
                         ms / lib_ms))
            if label == "slice":
                kernels.append({
                    "name": name, "route": "cuda",
                    "source": "chip_smoke.py",
                    "replaces": "mxtpu/rtc.py:174",
                    "launches": fit_launches[name],
                    "max_abs_err": cs_errs[name], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": lib_ms})
    # the floor under the slice's times: an empty rtc kernel on the same
    # grid as cs_softmax_fwd at (128, 10), held the same way
    empty = mt.rtc.CudaModule(EMPTY_SOURCE).get_kernel("empty", "float *o")
    xg, yg, _lab, _dx = cs_in[(CS_BATCH, CS_CLASSES)]
    grid, block = cs_softmax_fwd_dims(CS_BATCH, CS_CLASSES)
    print("time an empty rtc kernel, grid %d x %d threads (card time per "
          "call, events behind a sleep): %.5f ms | %s"
          % (grid, block, held_ms(lambda: empty.launch(
              (yg,), gpu, (grid, 1, 1), (block, 1, 1))), card))
    print("NVRTC compile (first launch of each module): protocol cases "
          "%.1f ms, custom-softmax head %.1f ms" % (rtc_mod.compile_ms,
                                                    cs_module().compile_ms))
    # host cost of one launch (signature checks, packing, cuLaunchKernel)
    # beside one eager torch op, host clock over many enqueues
    xg, yg, lab, dx = cs_in[(CS_BATCH, CS_CLASSES)]
    host = {}
    for what, fn in (("rtc launch", lambda: cs_softmax_fwd(xg, yg)),
                     ("torch.softmax", lambda: torch.softmax(xg.data, 1))):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        host[what] = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
    print("host us per call: rtc launch of cs_softmax_fwd %.2f us, eager "
          "torch.softmax %.2f us" % (host["rtc launch"],
                                     host["torch.softmax"]))
    cs_step_ms = cs_train_s / CS_STEPS * 1e3
    print("slice custom-op train: %.3f ms per step over %d steps (batch %d) "
          "| %s" % (cs_step_ms, CS_STEPS, CS_BATCH, card))
    print("Module.fit step (fit's loop body, host clock), eager / captured: "
          "MLP %.3f / %.3f ms, LeNet %.3f / %.3f ms; the hand-written cs_step "
          "loop %.3f ms | %s"
          % (fit_step_ms["MLP"]["eager"], fit_step_ms["MLP"]["captured"],
             fit_step_ms["LeNet"]["eager"], fit_step_ms["LeNet"]["captured"],
             cs_step_ms, card))
    few = cs_b[:8]
    busy, top = device_time(lambda: cs_train(mt, cs_p0, xs, ys, few), 1,
                            per=len(few))
    print("slice custom-op train step on the card (profiler): %s per step; "
          "per step: %s" % (busy_of(busy, cs_step_ms), top))
    req = x_all[:CS_BUCKETS[-1]]
    for _ in range(3):
        cs_engine.predict([req])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        cs_engine.predict([req])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print("slice custom-op bucket %d: %.2f requests/s (%.3f ms per request, "
          "numpy in and out) | %s" % (CS_BUCKETS[-1], reps / dt,
                                      dt / reps * 1e3, card))
    print("ResNet slice, ms a step: %s | %s" % (
        ", ".join("%s %s %.3f" % (k + (v,)) for k, v in resnet_ms.items()),
        card))
    print("Gluon ResNet-18 slice, ms a step: %s | %s" % (
        ", ".join("%s %s %.3f" % (k + (v,)) for k, v in gluon_ms.items()),
        card))
    print("CIFAR ResNet-110 slice, ms a step: %s | %s" % (
        ", ".join("%s %s %.3f" % (k + (v,)) for k, v in cifar_ms.items()),
        card))
    print("SSD-300 slice, ms a step: %s | %s" % (
        ", ".join("%s %s %.3f" % (k + (v,)) for k, v in ssd_ms.items()),
        card))
    print("multitask fused step, ms: %s; data files, ms a step: %s; who "
          "sets the fed pace: %s | %s" % (
              ", ".join("%s %.3f" % kv for kv in multitask_ms.items()),
              ", ".join("%s %s %.3f" % (k + (v,))
                        for k, v in files_ms.items()),
              ", ".join("%s: %s" % kv for kv in paces.items()), card))
    print("FCN-8s at %dx%d, ms a step: %s | %s" % (
        FCN_HW, FCN_HW, ", ".join("%s %.3f" % kv for kv in fcn_ms.items()),
        card))
    print("ResNet-50 captured step, TF32 off: NAG (fit.py's flags) %.3f ms, "
          "SGD %.3f ms; optimizers captured %d of %d (%s) | %s"
          % (ff_ms, resnet_ms[("captured", "TF32 off")],
             sum(r == "captured" for r in opt_routes.values()),
             len(opt_routes), ", ".join(
                 "%s %s" % kv for kv in sorted(opt_routes.items())), card))
    nms_ms, nms_plain, nms_bound, nms_by = nms_timing[1]
    kernels.append({
        "name": "multibox_nms", "route": "cuda",
        "source": "mxtpu_torch/csrc/vision.cu",
        "replaces": "mxtpu/ops/vision.py:311",
        "launches": nms_launches, "launches_rcnn_toy": rcnn_launches,
        "launches_box_nms": box_nms_timing[0],
        "box_nms_ms": box_nms_timing[1],
        "max_abs_err": nms_err, "ms": nms_ms,
        "plain_ms": nms_plain, "bound_ms": nms_bound, "bound_by": nms_by,
        "library_ms": None, "proposal_ms": proposal_timing[0],
        "proposal_plain_ms": proposal_timing[1],
        "proposal_bound_ms": proposal_timing[2]})

    print("sparse slice: Avazu sparse LR %.3f ms a step (bound %.5f ms), "
          "the fit's memory rise %.1f MB, held-out accuracy %.4f; "
          "SparseEmbedding 793,471 x 512 step %.1f ms, the backward's "
          "memory rise %.2f MB | %s"
          % (sparse_av["ms"], sparse_av["bound_ms"], sparse_av["peak_mb"],
             sparse_av["acc"], sparse_se["ms"], sparse_se["backward_mb"],
             card))
    amp_ms = durable["resnet"]
    print("durability and precision: ResNet-50 captured ms a step %s; the "
          "AMP LM ms a step by bucket %s (float32 %s); CheckpointManager's "
          "save blocked %.1f ms, wrote %.3f s, %.1f MB; --dtype float16 "
          "%.3f ms a step | %s"
          % (", ".join("%s %.3f" % kv for kv in amp_ms.items()),
             {k: round(v, 3) for k, v in durable["lm"][1]["amp"].items()},
             {k: round(v, 3) for k, v in durable["lm"][1]["f32"].items()},
             durable["ckpt"][0], durable["ckpt"][1], durable["ckpt"][2],
             durable["f16"], card))
    print("total %.1f s" % (time.time() - t_start))

    # 39.-40. the result lines
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
