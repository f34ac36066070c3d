"""Smoke test of the PyTorch/CUDA port (``bigdl_tpu_torch``) on one NVIDIA card.

Drives the port's nineteen main paths and holds every kernel of them against
its plain PyTorch version.  Serving: an int8-quantized ResNet-50 (1000
classes, 224x224, NCHW, random weights from a seed) served by
``ModelRegistry`` with ``quantize=True`` (weight_only) and
``quantize="dynamic"`` (kernel B4).  Training: PTB-medium (vocab 10000,
650x2 LSTM, T=35, batch 20, f32) trained through ``LocalOptimizer`` in
K=8-step blocks with SGD at lr 1.0 and global-norm clipping at 5.0, layer
0's LSTM cell running kernels B2f and B2b; and ResNet-50 (1000 classes,
224x224, NHWC, bf16 compute, batch 256) trained through ``LocalOptimizer``
in K=4 blocks with the ImageNet recipe's SGD, schedule and augmentation
pipeline, the stem max pool's backward running kernel B1; and the census
Wide&Deep (wide table 100,000 x 1, deep fields 10000/1000/100/100/50 at
embed 16, 13 dense features, MLP (100, 50), batch 8192 with 8 wide ids a
sample, f32) trained through ``LocalOptimizer`` in K=8 blocks with Adam at
lr 0.01 on batch-COO ``SparseMiniBatch`` es, the wide part's forward and
its weight gradient running kernel B3; and LeNet-5 (NCHW f32) trained on
synthetic MNIST at MNIST's counts with the recipe of
``examples/lenet/train.py`` (SGD lr 0.05, momentum 0.9, batch 128, two
epochs, validation and a snapshot every epoch, both summaries), its two
pools' backward running kernel B1; and ResNet-50's ImageNet recipe again,
through ``Optimizer.create(..., distributed=True)``: the data-parallel
``DistriOptimizer`` with the bucketed ZeRO-1 gradient sync at world 1 over
NCCL, the stem pool's backward on B1; and the CIFAR-10 recipes of
``examples/vgg/train.py`` and ``examples/resnet/train_cifar10.py`` (VGG
for CIFAR-10 and ResNet-20, NCHW f32, batch 128, on 25,000 synthetic
images through the recipe's pad/crop/flip pipeline, Top-1 over 10,000),
VGG's five pools on B1; and Inception v1 at ``bench.py``'s configuration
(NHWC, bf16 compute, batch 256, 224x224, 1000 classes) with the recipe of
``examples/inception/train.py``, its 13 pools on B1; and the MNIST
autoencoder of ``examples/autoencoder/train.py`` (784 -> 32 -> 784, batch
128, Adagrad, MSE, five epochs of 60,000 synthetic images) with every other
optim method and the L1/L2 regularizers; and ResNet-50 under each
rematerialization mode (``resnet50(remat=True|"tails")``,
``set_activation_memory("dots"|"full")``), B1 at its stem pool inside the
recomputed steps; and the text path of ``examples/rnn/train.py`` at its
defaults, PTB-small (vocab 10000, 2x200 LSTM, 20 steps, batch 20, Adam
lr 0.005) read from a PTB-format file through ``read_ptb_words``,
``Dictionary``, ``ptb_batches`` and ``SampleToMiniBatch``, layer 0's LSTM
cell on B2f and B2b at (20, 200), with ``simple_rnn`` through the one-hot
sentence chain and the text CNN of ``examples/textclassification/train.py``;
and every layer and criterion of the nn core that the text slice added;
and the resilience and telemetry plane around PTB-medium, LeNet-5 and the
int8 serving path (fault plans, elastic membership over two processes,
the tracer, watchdogs, flight recorder, admin plane, lockdep, spmdcheck);
and models read from files (BigDL, Caffe, Torch7, TensorFlow); and batch
prediction, evaluation and the estimator (``Predictor``, ``Evaluator``,
``PredictionService``, ``NNClassifier``, the image chain), with the int8
ResNet-50 on B4 and LeNet-5's pools on B1; and the Keras surface (the
Keras LeNet on B1, Keras text classifiers with a bidirectional LSTM on
B2f/B2b, a Keras JSON deployed, ``TFSession``); and the rest of serving
over the wire: the front end (``FrontendServer``, both connection cores)
before the int8 ResNet-50's two registry versions and a 2-replica
``ReplicaSet`` on the one card (B4), a replica death failed over, the
status taxonomy, and ``transformer_lm`` at its defaults decoding streams
through ``DecodeService`` with a hot cutover; and tensor parallelism on a
model group of the one card twice (``[cuda:0, cuda:0]``):
``transformer_lm(shard=True)`` at its defaults forward, trained through
``DistriOptimizer(param_specs=)``, served by a ``ShardedReplicaSet`` behind
the front end and decoded by ``DecodeService(mesh=)`` with its KV cache
split on the heads, and the int8 ResNet-50 in NHWC on B4; and the
ImageNet recipe of ``examples/resnet/train_imagenet.py --seqfiles`` fed
from Hadoop SequenceFiles (ResNet-50, NHWC, bf16, batch 256, B1 at the
stem), with the rest of ``nn/`` at the sizes its users run it: SSD300's
priors and output head, Faster R-CNN VGG16's proposals, RoI pooling and
output head, the Tree-LSTM sentiment recipe, a ``BinaryTreeLSTM`` at SST
widths, a trained ``While``, the volumetric and extras layers, and LeNet-5
in f16 with B1 in f16; and f16 compute on the other four kernels:
PTB-medium (B2f, B2b) and the census Wide&Deep (B3) trained in f16, and
the int8 ResNet-50 served on f16 rows (B4).
Phases, each printing its seconds:

1. the card: name, count, ``nvidia-smi`` name and power limit;
2. the kernels, built from ``bigdl_tpu_torch/csrc`` (one ``nvcc`` a
   source, in parallel; build seconds and the ``-Xptxas -v`` report);
3. int8 kernel phase: every distinct GEMM of a batch-32 ResNet-50 forward
   (and the same K, O at 1 and 37 rows), in both modes, with and without
   bias, weight_only in f32, bf16 and f16, against
   ``int8_matmul_reference`` on the card (dynamic bitwise, weight_only
   within ``rtol=1e-5, atol=1e-5*max|y|``), at 37 rows also from a base one
   element off its boundary (the mma variant), and the variant each GEMM
   took in each mode (the ``mma.sync`` kernel where TMA cannot describe
   the rows, the wgmma one elsewhere), then per shape and summed per
   forward the kernel's and the library call's device time
   (torch.profiler), event-timed loops of kernel, plain version and
   library call, and the least time the card could take (the bound;
   weight_only's also on the CUDA cores alone); at a K that is no multiple
   of 16 (the stem) bf16 rows are timed too, beside a bf16 ``addmm``;
4. int8 profile phase, per mode: device time by kernel of one batch-32
   forward (torch.profiler) against its wall time;
5. serving phase, per mode: 8 client threads x 16 requests of 1-4 rows,
   then 4 sampled requests served alone that must agree with the same
   model run on the CPU through the plain versions within 1e-5 of
   max|y|, a limit that two planted faults must exceed; the kernel's launch
   count must equal 54 x dispatches (in both modes 1 mma, the stem, and
   53 wgmma) and warmup must not grow;
6. LSTM kernel phase: B2f and B2b against their plain versions at the
   seven (N, H) shapes of ``CELL_SHAPES``, f32 and bf16, forget_bias 0 and
   1, then their times at (20, 650) and (20, 200) f32 beside the bound,
   the plain version and PyTorch's fused cell, with B2f's CTAs and cluster
   size and
   B2b's grid beside the floor of its launches (an empty kernel of the
   same grid);
7. training phase: one K=8 block on the card against the same steps on
   the CPU through the plain versions (within ``TRAIN_TOL``, a limit two
   planted faults must exceed); four timed blocks (words/s, ms per step,
   peak memory, the loss must fall) whose kernel launches must equal 35 x
   steps each; one step under torch.profiler (device idle share);
8. pool-kernel phase: B1 against its plain version, bitwise, at 20
   geometries (``POOL_CASES``: every branch of the three variants), each
   taking the variant ``TILED_CASES`` says, then at the ResNet-50 stem in bf16 and
   f32 its error on the timed inputs and its time beside the bound, the
   plain version and PyTorch's ``max_pool2d_with_indices_backward``;
9. resnet-train timed phase: the recipe twice, 8 steps each, through its
   own pipeline (8 worker threads) and over batches augmented beforehand
   (images/s, ms per step, block losses that must be finite and fall,
   peak memory, B1 launches that must equal the steps, all bf16 and all
   ``tiled_nhwc``), then one profiled step;
10. resnet-train check phase, f32, batch 8, card against CPU: one K=2
   block with the residual gammas at 0 (``grad_reading``), and each of
   the 53 conv+BatchNorm units alone at the model's init
   (``unit_reading``), both within ``RESNET_TRAIN_TOL``, a limit three
   planted faults must exceed;
11. bag-kernel phase: B3 against its plain version, bitwise, forward and
   the swapped-role weight gradient, at the 10 cases of ``BAG_CASES`` (the
   census shape, D 16/128/129, unsorted rows with empty rows and the
   padding tail, bf16, a single row, 64-bit offsets, every entry on one
   key), its grouping passes' (perm, offsets) bitwise against the
   library's ``row_index`` there in both roles and alone at the 7
   ``GROUP_EDGE_CASES`` (keys below 0 and at or above n_keys: offsets in
   full, perm over the bounds, the keys outside each on its side in nnz
   order), then at the
   census shape one call with host syncs made errors, the whole call's
   device time split by kernel (only ``csrc/embed_bag.cu``'s), beside the
   bound, the plain version, ``F.embedding_bag`` on the pre-sorted stream
   and the library route (sort, searchsorted, ``F.embedding_bag``);
12. wide-deep timed phase: the census Wide&Deep twice, 32 steps each,
   through the recipe's feed (``SparseSample`` >> ``batch_sparse_samples``)
   and over batches built beforehand (records/s, ms per step, peak
   memory, block losses that must fall on a planted teacher's labels, B3
   launches that must equal 2 a step), then one profiled step;
13. wide-deep check phase, card against CPU: one K=8 block step by step
   (``wd_step_reading``) within ``WD_TRAIN_TOL``, a limit three planted
   faults must exceed;
14. lenet pool phase: B1 at LeNet's two pools (batch 128: x (128, 6, 24,
   24) and (128, 12, 8, 8), 2x2/2, NCHW f32), bitwise against its plain
   version in ``tiled_nchw``, then on tanh outputs its device time beside
   the bound, the plain version and ``max_pool2d_with_indices_backward``;
15. lenet timed phase: the recipe for one epoch (samples/s, ms per step,
   peak memory, Top-1/Top-5 after each epoch over the 10,000 validation
   images, each snapshot's commit ms and bytes); Top-1 after the last
   epoch must exceed 0.9, the loss must fall and B1 must launch 2 a step
   (validation runs the forward only); one profiled step;
16. lenet check phase, card against CPU: one K=4 block step by step
   (``wd_step_reading``) and the validation log-probabilities of the
   trained weights within ``LENET_TRAIN_TOL``, a limit two planted faults
   must exceed;
17. lenet resume phase, under ``torch.use_deterministic_algorithms``: at
   K=1 and K=4 a run cut by a SIGTERM mid-epoch (preemption handling) and
   resumed by a fresh optimizer must equal the uninterrupted run bitwise,
   losses and weights; at K=4 the preemption's snapshot is truncated on
   disk first and ``latest_valid`` must skip it;
18. distri phase, ResNet-50 through ``DistriOptimizer`` at world 1 over
   NCCL with the f32 wire, then the bf16 wire: a warm-up and a timed
   K=4 block over pre-augmented images, and with the f32 wire a warm-up
   and one timed block through the recipe's pipeline (the pipeline bounds
   both wires alike) (images/s, ms per step, peak memory, the
   bucket count, block losses that must fall, B1 launches that must equal
   the steps), then one profiled step a wire with the sync's device ms by
   phase (the kernels of the ``grad_sync.<phase>`` ranges);
19. distri vs local: one K=4 block through ``DistriOptimizer`` (f32 wire)
   and through ``LocalOptimizer`` from the same weights and data, LeNet-5
   under ``torch.use_deterministic_algorithms`` and ResNet-50 under
   cuDNN's deterministic algorithms: losses and weights bitwise equal;
20. distri world 2: B1 against its plain version, bitwise, at LeNet's two
   pools at batch 64; two spawned processes on the one card over gloo,
   LeNet at batch 64 a process: the f32 wire bitwise equal to the
   all-reduce path, the ranks equal, the f32 master slices reassembled
   into the weights exactly, the bf16 wire's masters within
   ``WIRE_DRIFT_LIMIT`` of the f32 wire's weights and its published
   weights its masters rounded to bf16, with two planted faults that
   must each fail one of those, B1 two launches a step;
21. distri resume: a grad_sync snapshot at iteration 4 (the reference's
   ``{"master", "opt"}`` layout) resumed by a fresh optimizer ends
   bitwise where the uninterrupted run ends (LeNet, K=4);
22. cifar: B1 at VGG's five pools (``VGG_POOL_CASES``, batch 128, NCHW
   f32, ``tiled_nchw``) bitwise against its plain version, then timed
   beside the bound and the library; VGG one epoch and ResNet-20
   ``CIFAR["steps"]`` steps through LocalOptimizer and VGG
   ``CIFAR["steps"]`` steps through the DistriOptimizer the recipe's
   ``--distributed`` builds (world 1, NCCL), each printing images/s, ms
   a step, peak memory, Top-1 and a profiled step; the loss must fall,
   Top-1 pass ``CIFAR["min_top1"]``, B1 launch 5 times a VGG step (all
   ``tiled_nchw``) and never for ResNet-20;
   then VGG's world-1 DistriOptimizer against LocalOptimizer over a K=4
   block under the deterministic algorithms: bitwise;
23. inception: B1 at Inception v1's 10 distinct NHWC bf16 geometries at
   batch 256 (``tiled_nhwc``) and 3 NCHW f32 ones at batch 4
   (``tiled_nchw``: a 3x3/2 ceil-mode pool, 3x3/1 pad 1 pools), bitwise and
   timed; two timed runs of the recipe (pre-augmented and through its
   pipeline, 4 timed steps each, two blocks an epoch: images/s, ms a
   step, peak memory, a profiled K=4 block's idle share and top
   operations, B1 13 launches a step, all bf16
   ``tiled_nhwc``); then an NCHW f32 Inception v1 (its LRNs at an even
   size and alpha 1, dropout off) through one K=4 block on the card
   against the CPU step by step (``wd_step_reading``, each gradient by
   its norm share) within
   ``INCEPTION_TRAIN_TOL``, a limit two planted faults must exceed (the
   LRN's torch window, two towers of module 4a swapped);
24. autoencoder: the recipe for five epochs through LocalOptimizer at K
   from ``Engine.steps_per_dispatch()`` (ms a step and samples/s over
   epochs 2-5, peak memory, a profiled block, each epoch's loss, which
   must fall, and the reconstruction MSE of 256 images); then one K=4
   block of each method (SGD with a bf16 velocity, ParallelAdam, Adagrad,
   Adadelta, Adamax, RMSprop, Ftrl, LBFGS, and Adagrad with
   ``L1L2Regularizer(1e-4, 1e-4)`` on both Linears) on the card against
   the CPU step by step (``ae_step_reading``: loss, gradients, update and
   state) within ``AE_STEP_TOL``, a limit two planted faults must exceed
   (Adagrad's epsilon inside the root, Adadelta's accumulators swapped);
   LBFGS's update with host syncs made errors; each elementwise method
   through a world-1 DistriOptimizer over NCCL bitwise equal to
   LocalOptimizer, LBFGS refused by the ZeRO-1 path and bitwise on
   ``parameter_sharding=False``;
25. remat: ResNet-50 at batch 32 under
   ``torch.use_deterministic_algorithms``, one K=4 block in each of
   ``REMAT_MODES`` at f32 and in no remat, remat=True and "tails" under
   bf16 compute: losses, weights and BatchNorm statistics bitwise equal
   to remat=False's at the same dtype, B1 once a step, two planted
   faults (BatchNorm updated again in the recomputed forward; Remat
   keeping its block's parameters out of the checkpoint, in bf16) that
   must break it; then
   ``bench.py``'s configuration (NHWC, bf16, batch 256, 1,024
   pre-augmented images) in each of ``REMAT_TIMED``, 8 timed steps (ms a
   step, images/s, peak memory, B1 once a step), and a profiled step of
   a second, short run (device time, idle share);
26. resilience: PTB-medium, ``RESIL["ptb_steps"]`` steps at K=8, with
   everything off and then with telemetry (a trace path), the flight
   recorder, the admin plane (an ephemeral loopback port), lockdep and
   spmdcheck on: the losses bitwise equal (deterministic algorithms),
   B2f/B2b 35 launches a training step in each, the trace's five phase
   categories read as ``tools/trace_report.py`` reads them, ``/metrics``,
   ``/healthz``, ``/trace`` and ``/flight`` answering during the run, the
   memory gauges equal to ``torch.cuda.memory_stats``, no lock-order
   cycle and no schedule divergence; a ``/profile?seconds=1`` capture
   taken during a third run must hold B2f's kernel.  LeNet-5 under
   ``LENET_PLAN`` with the guard's skip and rollback policies: the skipped
   steps exactly 5 and 9, the reference's flight events, the retry
   counted, the skip run within ``LENET_TRAIN_TOL`` of the CPU step by
   step, B1 bitwise at both pools and 2 launches a step.  LeNet through
   ``DistriOptimizer`` over two processes on the card under
   ``ELASTIC_PLAN``: membership [2, 1, 2], no step lost, bitwise to the
   replay boundary against an uninterrupted world-2 run, the whole run
   within ``ELASTIC_TOL``, which two planted faults must exceed; and
   under ``LOSS_PLAN``.  The int8 ResNet-50 (weight_only) served under
   ``SERVE_PLAN`` with request tracing: the injected error, the batcher's
   death and ``revive()``, the other requests bitwise equal to a
   fault-free service's, one flow a request, B4 54 launches a forward and
   within its tolerance of its plain version at the served GEMMs;
27. interop, under ``torch.use_deterministic_algorithms``: ResNet-50
   (seeded weights, BatchNorm running statistics drawn from the seed)
   written to ``.bigdl`` and to a frozen GraphDef and each loaded onto the
   card: the batch-32 forward bitwise for ``.bigdl``, within
   ``INTEROP_TOL`` for the GraphDef (BatchNorm folded), a limit that a
   file with one 3x3 kernel transposed must exceed; its bottlenecks as an
   ``nn.Graph`` (``resnet50_graph``, Caffe's layout) through Caffe (within
   ``INTEROP_TOL``, the same planted fault) and ``.bigdl`` (bitwise);
   VGG-16 through ``.t7`` and Inception v1 through ``.bigdl``, bitwise;
   bytes and write, load and first-forward seconds of each file;
   ``python -m bigdl_tpu_torch.interop.convert_model --quantize`` of the
   ResNet-50 file in both modes (its parity check passing), each
   quantized file and the float file with ``quantize=`` deployed by
   ``ModelRegistry(device="cuda")`` and served to 8 client threads x 4
   requests of 1-4 rows (rows/s, latency p50/p99): every dispatched batch
   bitwise through the in-memory quantized deploy, B4 54 launches a
   dispatch; the Caffe and GraphDef files served in float within
   ``INTEROP_TOL``; a hand-built TF while loop (two loop variables, a
   nested frame) on the card bitwise the CPU.  The files live in a
   temporary directory removed at the end;
28. predict: LeNet-5 (seeded) written to ``.bigdl``, loaded, evaluated by
   ``Evaluator`` (Top-1, Top-5, Loss) over the 10,000 validation images
   at batch 128 (a 16-row last batch) and predicted by ``Predictor``,
   against the CPU (counts equal, hits equal but at near ties, the
   log-probabilities within ``PREDICT_TOL``, a limit two planted faults
   must exceed); the int8 ResNet-50 in both modes through ``Predictor``
   over one batch of 32 images (B4 54 launches a forward) and
   ``PredictionService``
   (8 threads x 4 requests of 1-4 rows), every row against the CPU;
   Inception v1 over 64 PNGs (280x320) read by ``ImageFrame.read``
   through the image-classification example's chain; ``NNClassifier``
   (LeNet-5, 3 epochs of 4,096, B1 2 a step, ``transform`` against the
   CPU's argmax) and the ML-pipeline example's two small estimators;
29. keras: the Keras LeNet of ``examples/lenet/train_keras.py`` (compile,
   fit 3 epochs of 4,096 with validation, evaluate, predict; B1 2 a
   step; a K=4 block against the CPU step by step within ``KERAS_TOL``,
   two planted faults), its Keras-1.2 JSON loaded, the trained weights
   set in Keras order and deployed from the file; two text classifiers
   (``Embedding >> Bidirectional(LSTM(128)|GRU(128)) >> Dense(20)``)
   over ``synthetic_news(4096, 20)`` padded to 200 tokens, batch 128, B2f
   and B2b 400 launches an LSTM step, one step of each against the CPU;
   B2f/B2b at (128, 128) against their plain versions and timed;
   ``TFSession`` training a re-imported GraphDef and a queue-fed one
   over a TFRecord file;
30. frontend: ``FrontendServer`` on both cores (``eventloop``,
   ``threaded``) before the registry's int8 ResNet-50 v1 (weight_only)
   and v2 (dynamic) and a 2-replica ``ReplicaSet`` on ``cuda:0``: 8
   clients x 4 requests of 1-4 rows, JSON and npy bodies, every row
   within ``SERVE_TOL`` of the CPU (a dynamic request goes alone: its
   activation scale is its batch's), B4 54 launches a dispatch, rows/s
   and latency p50/p99 a core; a second set under
   ``replica_death@target=0,after=5,count=1`` (every request answered,
   the flight recorder's death, failover and revival against the
   counters, the failed-over requests' latency); 504 past a queued
   ``X-Deadline-Ms``, 429 with ``Retry-After`` on a full queue, 404;
   ``transformer_lm()`` at its defaults in ``DecodeService(slots=8,
   max_seq_len=512)``, prompt buckets ``pow2@8`` to 256: 16 concurrent
   streams over both cores, each in order and closed by its trailer,
   the served tokens fed through the card's decode carry within
   ``GEN_TOL`` of the CPU's and the card's full-context forwards (three
   planted faults must exceed it), tokens/s, step ms, time to first
   token p50/p99, the KV bytes, one step alone; a ``HotCutover`` of the
   decode backend under 8 streaming clients with no stream dropped;
31. parallel (``PARALLEL``): ``transformer_lm(shard=True)`` at its
   defaults (52,763,904 parameters) on the model group ``[cuda:0,
   cuda:0]`` (the copies between its devices are then no-ops): its
   log-probs of 4 x 256 tokens against the unsharded model on the card
   within ``TP_TOL`` of max|logp|, two halves of a split ``wq`` swapped
   above ``TP_FAULT_FLOOR``; ``DistriOptimizer(param_specs=)`` at world 1
   over NCCL (data=1, model=2), Adam, batch 8 x 256, 4 steps, each step's
   loss and gradients redone by the unsharded model from the step's own
   weights within ``TP_TRAIN_TOL`` (a row sum that drops its last partial
   above it), ms a step beside the unsharded run's; a
   ``ShardedReplicaSet`` (``[cuda:0] * 4`` in groups of two) behind the
   front end, 8 clients x 4 requests of 1-4 rows of 128 tokens, every row
   within ``TP_TOL`` of the unsharded model, grown to 3 slots that answer
   again; ``DecodeService(mesh=)`` (slots 8, max_seq_len 512) decoding 16
   streams, teacher-forced within ``GEN_TOL`` of the unsharded full
   context with three planted faults above it, near ties counted, the KV
   bytes a shard (half the cache); and the int8 ResNet-50 in NHWC, both
   modes through ``ModelRegistry.deploy(quantize=...)``, its rows bitwise
   its NCHW twin's, B4 54 launches a dispatch; B4 is checked and timed
   at the NHWC path's GEMMs (batch 8, the NCHW twin's shapes) beside the
   bound, the plain version and the library call early in the run, after
   the int8 kernel phase (``int8-kernels-nhwc``: late in a long run the
   profiler loses whole sessions);
32. quantized-rnn (``QRNN``): the two Keras text classifiers of the keras
   phase (``Embedding(vocab, 100) >> Bidirectional(LSTM(128) | GRU(128))
   >> Dense(20)``, seeded) deployed through ``ModelRegistry.deploy`` with
   ``quantize=True`` and ``"dynamic"``, their recurrent cells int8
   (``QuantizedLSTM``/``QuantizedGRU``, every step's projection of
   ``[x_t, h]`` one B4 launch): requests of 128 rows of 200 tokens, each
   alone, every row within ``QRNN_TOL`` of max|y| of the same quantized
   model on the CPU, two planted faults (the LSTM's i and f gates
   swapped, a GRU candidate panel x127/128) above it; B4 401 launches an
   LSTM forward and 801 a GRU forward, the fused LSTM cell (B2f/B2b)
   none; B4 checked and timed at the cells' GEMMs (M 128, K 228: mma)
   and the head's early in the run, after the int8 kernel phase
   (``int8-kernels-qrnn``), the dequantized-f32 ``addmm`` the library
   call in both modes, and for dynamic also ``_int_mm`` (K zero-padded to
   232 outside the timed call);
33. seq-pipe (``SEQPIPE``): ``ring_attention`` at ``transformer_lm()``'s
   head geometry (B 2, H 8, D 64, T 8192) on ``seq`` groups ``[cuda:0] *
   2`` and ``* 4``, causal and not, f32 and bf16, the output and the
   gradients of ``sum(out**2)`` against the full ``dot_product_attention``
   on the card within ``RING_TOL`` (the source rank's offset dropped from
   the causal mask above it), peak memory of each; ``GPipe`` of four
   ``transformer_block(512, 8, 2048)`` stages on ``[cuda:0] * 4``, 8
   microbatches of 4 x 256 tokens, against ``apply_reference`` within
   ``PIPE_TOL``, then 4 SGD steps of a mean-square loss each redone
   through ``apply_reference`` from the step's own weights (microbatch
   order shifted by one above the limit); ``MicrobatchedSequential`` of
   ``partition_sequential(transformer_lm(), 4)`` over 4 microbatches of 4
   x 256 tokens, forward and gradients against the unpipelined model;
   ``NeuralCF`` at MovieLens-1M's counts (6,040 users, 3,706 items)
   trained 8 steps through ``LocalOptimizer`` (Adam, BCE, batch 256), each
   step redone on the CPU from the card's weights; the peephole cells and
   ``RecurrentDecoder``, one forward each against the CPU;
34. seqfile (after resnet-train, on its 1,024 recipe samples): the samples
   written as the reference's ImageNet sequence files (keys
   ``"<name>\n<label>"``, 1-based labels, raw HWC uint8 values; two plain
   files, one record-compressed, one block-compressed) and read back
   through ``dataset.seqfile.image_samples`` (``label - 1``): every record
   bitwise the written sample; the recipe pipeline's first batch from the
   files bitwise the in-memory one's; one K=4 block of the recipe
   (``resnet50(format="NHWC")``, bf16, batch 256, ``MTSampleToMiniBatch``
   at 8 workers, cuDNN's deterministic algorithms) fed from the files
   bitwise the memory-fed block (losses and weights), B1 4 ``tiled_nhwc``
   bf16 launches in it; planted faults (labels kept 1-based, one byte
   flipped, the records reversed: a one-step block for the losses) must
   break each check; write and read seconds, images/s;
35. tail: B1 in f16 at every case of ``F16_POOL_CASES``, bitwise, and timed
   at the stem and LeNet's pools beside the bound, the plain version and
   the library (early, after the seqfile phase); SSD300's 8732 priors
   over its six maps and ``DetectionOutputSSD`` at 21 classes, batch 8,
   ``nms_topk`` 400, ``keep_topk`` 200; Faster R-CNN VGG16 at test time
   (``Proposal`` pre-NMS 6000, post-NMS 300 over a 38x50 map,
   ``RoiPooling`` 7x7 at 1/16 over (1, 512, 38, 50), peak memory,
   ``DetectionOutputFrcnn`` at 21 classes and 100 detections): each
   decode within ``TAIL_TOL`` of the CPU, each selection (batched NMS,
   the cuts) on the card's decoded boxes bitwise the CPU's, RoI pooling
   bitwise, each with a planted fault, times a call; the Tree-LSTM
   sentiment recipe (``examples/treeLSTMSentiment/train.py``: 256 trees
   of 6 leaves, embed 16, hidden 32, Adam 0.02, 60 steps) on the card
   step by step against the CPU (every step read against step 0's loss
   and gradients, a scale that does not vanish as the recipe fits its
   trees; two planted faults over the whole run), accuracy above 0.9, a
   ``BinaryTreeLSTM`` at embed 300, hidden 150 over 25 random trees of
   5-50 leaves, forward and backward against the CPU and timed; a
   ``DynamicGraph`` ``While`` (``max_trip_count`` 8, exit after 4, a body
   that is inf on a dead trip) trained 20 Adam steps, gradients finite
   and step by step against the CPU, its masked twin's NaN gradients the
   planted fault; each volumetric and extras layer of ``TAIL_LAYERS``
   forward and backward against the CPU; LeNet-5 300 steps in f16, B1 2
   f16 ``tiled_nchw`` launches a step, the loss falling;
36. f16: the f16 forms of B2f, B2b, B3 and B4 (early, after the seqfile
   phase): B2f and B2b at every ``CELL_SHAPES`` shape and forget_bias 0
   and 1 within ``CELL_TOL["float16"]`` of their plain versions, timed at
   (20, 650) beside the bound, the plain version and the library's f16
   cell; B3 bitwise at ``F16_BAG_CASES`` (an f16 table with f16 and f32
   values), timed at the census forward and table gradient; B4 on f16 rows
   at every distinct GEMM of the batch-32 ResNet-50 forward in both modes
   (weight_only's f16 mma form at the stem and its one-pass f16 ``wgmma``
   form elsewhere; dynamic bitwise), timed a forward.  Then (at the end)
   PTB-medium at full width trained with ``set_compute_dtype(float16)``
   for one K=8 block, B2f and B2b 35 f16 launches a step each, and the
   census Wide&Deep the same way, B3 2 calls a step (the forward on an f16
   table and values, the table gradient on the f32 cotangent and f16
   values), each step redone from the card's own weights and read
   (``wd_step_reading``, norm shares against step 0's) within ``F16``'s
   limits, with planted faults: PTB-medium against its plain cell on the
   card (the CPU's f16 embedding gradient adds in f16, which buries a cell
   fault; ``probes/f16_ptb_reading.py`` shows it), Wide&Deep against the
   CPU in f16; the int8 ResNet-50 deployed with an f16
   input spec, four lone requests a mode: 54 B4 launches a dispatch, the
   stem on the f16 rows (1 mma launch), the rest on f32 as in the
   reference, within ``SERVE_TOL`` of the CPU with the serving phase's
   planted faults.  The kernels line gives each of the four kernels an
   ``f16`` entry with its f16 launches and times.

The last lines are the card, the kernel table and the result as JSON; any
failed check raises and the script exits non-zero.  Without a CUDA card it
fails at once.  Run from the repository root:

    python3 chip_smoke.py [--seed N] [--json-out PATH]
                          [--phases resnet,lstm,resnet-train,wide-deep,lenet,
                                    distri,cifar,inception,autoencoder,remat,
                                    text,nn-core,resilience,interop,
                                    predict,keras,frontend,parallel,
                                    quantized-rnn,seq-pipe,seqfile,tail,
                                    f16]

``--phases resnet-conditioning`` adds a diagnostic that is not run by
default: the check phase's path reading at residual gammas 0 to 1, beside
the CPU's own reading on reordered batches.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import itertools
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

# cuBLAS's deterministic workspace setting (what the LeNet resume check's
# torch.use_deterministic_algorithms asks for), set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bigdl_tpu_torch import nn, optim  # noqa: E402
from bigdl_tpu_torch.checkpoint import load_snapshot  # noqa: E402
from bigdl_tpu_torch.checkpoint import manager as ckpt_manager  # noqa: E402
from bigdl_tpu_torch.dataset import (  # noqa: E402
    DataSet, MiniBatch, MTSampleToMiniBatch, Sample, SampleToMiniBatch,
    SparseMiniBatch,
    SparseSample, Transformer, batch_samples, batch_sparse_samples)
from bigdl_tpu_torch.dataset import cifar, image, mnist, text  # noqa: E402
from bigdl_tpu_torch.dataset.text import Dictionary  # noqa: E402
from bigdl_tpu_torch.engine import Engine  # noqa: E402
from bigdl_tpu_torch.models import (WideAndDeep, autoencoder,  # noqa: E402
                                    inception_v1, lenet5, ptb_model,
                                    resnet50, resnet_cifar, simple_rnn,
                                    vgg16, vgg_for_cifar10)
from bigdl_tpu_torch.nn import quantize, recurrent  # noqa: E402
from bigdl_tpu_torch.nn.quantized import (QuantizedLinear,  # noqa: E402
                                          QuantizedSpatialConvolution,
                                          _QuantizedCellBase)
from bigdl_tpu_torch.nn.tree import tree_plan  # noqa: E402
from bigdl_tpu_torch.ops import (  # noqa: E402
    _build, embed_bag, int8_gemm, lstm_cell, maxpool)
from bigdl_tpu_torch.ops.int8_gemm import (  # noqa: E402
    MODES, int8_matmul_reference, prepare_operands)
from bigdl_tpu_torch.optim import LocalOptimizer  # noqa: E402
from bigdl_tpu_torch.serving import ModelRegistry  # noqa: E402
from bigdl_tpu_torch.transform import vision as V  # noqa: E402
from bigdl_tpu_torch.utils.precision import mixed_precision_loss_fn  # noqa: E402
from bigdl_tpu_torch.utils.summary import (TrainSummary,  # noqa: E402
                                           ValidationSummary)

# H100 SXM data sheet, dense, at the 700 W limit
PEAK_F32 = 67e12       # FLOP/s on the CUDA cores
PEAK_BF16 = 989e12     # FLOP/s on the tensor cores (weight_only's products)
PEAK_INT8 = 1979e12    # OP/s on the tensor cores (dynamic's int8 products)
HBM_BPS = 3.35e12      # bytes/s
BATCH = 32
SPEC = ((3, 224, 224), np.float32)
KERNEL = {"route": "cuda", "source": "bigdl_tpu_torch/csrc/int8_gemm.cu",
          "replaces": "bigdl_tpu/ops/pallas_int8_gemm.py:207"}
# served output against the same model on the CPU, as a share of max|y|:
# weight_only sums in f32 on the card and in float64 on the CPU at each of
# 54 layers; in dynamic mode the GEMMs agree bitwise and only the float
# layers (pooling sums, log-softmax) differ by ulps.  Each limit sits
# between the sound reading and the readings of the planted faults below,
# which the run measures and requires to exceed it.
SERVE_TOL = {"weight_only": 1e-5, "dynamic": 1e-5}

# PTB-medium (bench.py's ptb_lstm workload): vocab 10000, embed and hidden
# 650, 2 LSTM layers, T=35, batch 20, dropout 0, f32, K=8 steps a block
PTB = {"vocab": 10000, "embed": 650, "hidden": 650, "layers": 2, "T": 35,
       "batch": 20, "K": 8}
PTB_BATCHES = 64   # batches per epoch of the synthetic corpus
# PTB-small, the text path (examples/rnn/train.py at its defaults; Zaremba,
# Sutskever and Vinyals 2014's "small": vocab 10000, 2x200 LSTM, 20 steps
# unrolled, batch 20), Adam lr 0.005, on a PTB-format file of ~95,000
# words over 9,999 distinct tokens that the text phase writes
PTB_SMALL = {"vocab": 10000, "embed": 200, "hidden": 200, "layers": 2,
             "T": 20, "batch": 20, "lr": 0.005, "words": 95_000,
             "distinct": 9999, "K": 4, "profile_at": 200, "timed_from": 20}
TIMED_BLOCKS = 3   # K-step blocks timed after one warm-up block
LSTM_KERNELS = {
    "lstm_cell_fwd": {"route": "cuda",
                      "source": "bigdl_tpu_torch/csrc/lstm_cell.cu",
                      "replaces": "bigdl_tpu/ops/pallas_lstm.py:153"},
    "lstm_cell_bwd": {"route": "cuda",
                      "source": "bigdl_tpu_torch/csrc/lstm_cell.cu",
                      "replaces": "bigdl_tpu/ops/pallas_lstm.py:181"},
}
# (N, H): PTB-medium's, PTB-small's (the text path's), tiny, ragged, N
# above one 32-row batch tile (37, 64), an odd H (333) that the
# forward's eight K slices do not divide and whose bf16 rows take its
# plain-load copies, and the Keras text classifier's (128, 128)
CELL_SHAPES = [(20, 650), (20, 200), (1, 64), (5, 130), (37, 650), (64, 650),
               (20, 333), (128, 128)]
# elementwise operations per hidden unit (transcendentals counted as one)
CELL_EW_OPS = {"lstm_cell_fwd": 20, "lstm_cell_bwd": 36}
# kernel against plain version (rtol = atol): bf16 and f16 results within
# one ulp of their type at values up to 2 (an f32 result near a rounding
# boundary of the type may round the other way); f32 results within 1e-5
# (expf/tanhf within ulps of PyTorch's), except the forward's at H=650,
# where the recurrent product sums 650 terms in another order than cuBLAS:
# 1e-4 there, the JAX cell test's own forward tolerance at that shape
# (tests/test_pallas_kernels.py)
CELL_TOL = {"bfloat16": 8e-3, "float16": 1e-3, "float32": 1e-5,
            "float32 long sum": 1e-4}


def cell_tol(kernel, H, dtype) -> float:
    if dtype in (torch.bfloat16, torch.float16):
        return CELL_TOL[str(dtype).split(".")[1]]
    long_sum = kernel == "lstm_cell_fwd" and H > 130
    return CELL_TOL["float32 long sum" if long_sum else "float32"]
# card training against the same steps on the CPU (train_reading): above
# the sound reading, below the two planted faults that every run measures
# and requires to exceed it
TRAIN_TOL = 1e-4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def gemm_shapes(model, device, batch=BATCH, spec=None):
    """[(M, K, O, has_bias)] of one forward of ``batch`` rows (32 by
    default) of the quantized ``model`` on zero inputs of ``spec`` (default
    ``SPEC``, NCHW; an integer spec gives token ids), in launch order, read
    from the layers' output shapes (an NHWC convolution's rows are its
    output's N x H x W too) and from each quantized recurrent cell's
    projections, one a step."""
    rec = []

    def hook(m, inp, out):
        O = m.weight_q.shape[0]
        K = m.weight_q[0].numel()
        hw = (1 if out.dim() != 4 else out.shape[1] * out.shape[2]
              if getattr(m, "format", "NCHW") == "NHWC"
              else out.shape[2] * out.shape[3])
        rec.append((out.shape[0] * hw, K, O, m.bias is not None))

    sound_proj = _QuantizedCellBase._proj

    def proj(self, x, wq, ws, bias):
        rec.append((x.shape[0], wq.shape[1], wq.shape[0], bias is not None))
        return sound_proj(self, x, wq, ws, bias)

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (QuantizedSpatialConvolution,
                                 QuantizedLinear))]
    shape, dtype = spec or SPEC
    _QuantizedCellBase._proj = proj
    try:
        with torch.inference_mode():
            model(torch.from_numpy(np.zeros((batch,) + shape, dtype))
                  .to(device))
        torch.cuda.synchronize()
    finally:
        _QuantizedCellBase._proj = sound_proj
        for h in handles:
            h.remove()
    return rec


def operands(M, K, O, xdtype, bias, gen, device):
    x = torch.randn(M, K, generator=gen, device=device)
    wq = torch.randint(-127, 128, (O, K), generator=gen, device=device,
                       dtype=torch.int8)
    scale = torch.rand(O, generator=gen, device=device) * 0.02 + 0.001
    b = torch.randn(O, generator=gen, device=device) if bias else None
    if xdtype == "int8":
        xin, scale = prepare_operands(x, scale, "dynamic")
        return xin, wq, scale, b
    return x.to(getattr(torch, xdtype)), wq, scale, b


def cuda_ms(fn, budget_ms=30.0):
    """Mean milliseconds of ``fn`` on the card, after a warmup call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    iters = int(min(100, max(3, budget_ms / max(start.elapsed_time(end),
                                                1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


SENTINEL_SPINS = 32


def sentinel():
    """Short spin kernels at the head of a profiled window, waited for:
    the trace can miss a session's first launches (after the distri
    phase, the first 18-20 of each session at a pool), and these it may
    miss.  :func:`device_time` leaves them out."""
    for _ in range(SENTINEL_SPINS):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def per_call_ms(kernels, calls):
    """{kernel: device ms per call} from a trace of ``calls`` calls: each
    kernel's mean time over the launches the trace holds, times its
    launches per call (a kernel seen fewer than calls / 2 times is no part
    of a call).  The trace can drop a launch or two of a long session, so
    a plain sum over the trace would read a little low."""
    return {name: ms / n * round(n / calls)
            for name, ms, n in kernels if round(n / calls) > 0}


def profiled_kernels(run, tries=8):
    """The kernels list (:func:`device_time`) of one torch.profiler session
    around ``run()``, after the :func:`sentinel`.  Now and then a session's
    trace holds no kernel at all, sometimes three in a row; such a session
    is taken again after a short pause, up to ``tries`` times, then
    fails."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(tries):
        if i:
            time.sleep(0.2)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sentinel()
            run()
            torch.cuda.synchronize()
        _, kernels, _ = device_time(prof)
        if kernels:
            return kernels
        print("profiler: a trace held no kernel; taken again")
    raise AssertionError(f"the profiler saw no device time in {tries} "
                         f"sessions")


def device_ms(fn, calls=50, split=None):
    """Device milliseconds of one call of ``fn``: the device time of the
    kernels it launches (torch.profiler) over ``calls`` calls after a
    warmup, per call (:func:`per_call_ms`).  The host's gaps between
    launches are left out; for a call of a few microseconds of device
    work they are most of what :func:`cuda_ms` measures.  A ``split``
    list receives (kernel, ms per call) of each kernel."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(calls):
            fn()

    # a trace that lost most launches is taken again, each time with
    # twice the calls, so that a session's lost head weighs less
    for _ in range(4):
        kernels = profiled_kernels(run)
        per_call = per_call_ms(kernels, calls)
        if per_call:
            break
        print(f"profiler: a trace lost most launches of {calls} calls ("
              + ", ".join(f"{n} x{c}" for n, _, c in kernels)[:300]
              + f"); taken again with {2 * calls}")
        calls *= 2
    else:
        raise AssertionError("the profiler saw no kernel of every call")
    if split is not None:
        split += list(per_call.items())
    return sum(per_call.values())


def gemm_device_ms(k_fn, l_fn, calls=20):
    """(kernel, library) device milliseconds a call: ``calls`` calls of each
    after a warmup, in one torch.profiler session, per call
    (:func:`per_call_ms`), the port's kernels told from the library's by
    name (``gemm_dynamic*``, ``gemm_weight_only``); library None when
    ``l_fn`` is None."""
    fns = [k_fn] + ([l_fn] if l_fn is not None else [])
    for fn in fns:
        fn()
    torch.cuda.synchronize()

    def run():
        for fn in fns:
            for _ in range(calls):
                fn()

    def ours(name):
        return "gemm_dynamic" in name or "gemm_weight_only" in name

    # a trace that lost the kernel's launches (a session can lose its
    # head, the kernel's calls come first) is taken again, each time with
    # twice the calls, so that a lost head weighs less (as device_ms does)
    for _ in range(6):
        per_call = per_call_ms(profiled_kernels(run), calls)
        mine = sum(ms for name, ms in per_call.items() if ours(name))
        if mine > 0:
            break
        print(f"profiler: a trace lost the kernel's launches; taken again "
              f"with {2 * calls} calls")
        calls *= 2
    else:
        raise AssertionError("the profiler saw no device time of the kernel")
    lib = sum(per_call.values()) - mine
    return mine, (lib if l_fn is not None else None)


def bound(M, K, O, bias, xdtype, cuda_cores=False):
    """(least ms, "bytes" | "operations", peak used) for one GEMM: each
    input read once, the output written once, against the card's memory
    rate and the peak rate of the operations.  int8 x: int8 products on
    the tensor cores.  f32 x: three exact bf16 products a term on the
    tensor cores (each f32 value is the sum of three bf16 terms, the
    kernel's split), bf16 or f16 x one (f16 at bf16's rate); with
    ``cuda_cores`` instead one f32 FMA a term on the CUDA cores."""
    xbytes = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}[xdtype]
    nbytes = M * K * xbytes + O * K + 4 * O * (2 if bias else 1) + 4 * M * O
    ops = 2.0 * M * K * O
    if xdtype == "int8":
        peak = PEAK_INT8
    elif cuda_cores:
        peak = PEAK_F32
    else:
        peak = PEAK_BF16
        ops *= 3 if xdtype == "float32" else 1
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", peak)


def int_mm_call(xin, wq):
    """``torch._int_mm`` on the int8 rows and panel (the int32 product
    alone), or None where its shape rules refuse (M of 16 rows or fewer, O
    not a multiple of 8).  It wants K a multiple of 8, so a ragged K (the
    stem's 147, the cells' 228) is padded with zero columns on both sides,
    outside the timed call: they leave the integer product unchanged."""
    M, K = xin.shape
    if M <= 16 or wq.shape[0] % 8:
        return None
    pad = -K % 8
    xp = torch.nn.functional.pad(xin, (0, pad))
    wt = torch.nn.functional.pad(wq, (0, pad)).T
    try:
        torch._int_mm(xp, wt)
    except RuntimeError:
        return None
    return lambda: torch._int_mm(xp, wt)


def library_call(xin, wq, scale, b, xdtype, dequantized=False):
    """One PyTorch call for the same product: addmm/mm on dequantized
    weights (weight_only, in x's dtype; dynamic too with ``dequantized``:
    its int8 rows as f32, the scale row folded into the weights), else
    :func:`int_mm_call` (dynamic), and the dequantized f32 ``addmm`` where
    ``_int_mm`` refuses the shape.  A yardstick; the port never calls
    it."""
    if xdtype == "int8" and not dequantized:
        lib = int_mm_call(xin, wq)
        if lib is not None:
            return lib
    dt = xin.dtype if xdtype in ("bfloat16", "float16") else torch.float32
    w = (wq.float() * scale[:, None]).T.to(dt)
    x = xin.to(dt)
    bb = None if b is None else b.to(dt)
    return (lambda: torch.addmm(bb, x, w)) if b is not None \
        else (lambda: torch.mm(x, w))


def kernel_phase(shapes, device, card, report, batch=BATCH,
                 dequantized_library=False):
    gen = torch.Generator(device=device).manual_seed(1234)
    counts = {}
    for s in shapes:
        counts[s] = counts.get(s, 0) + 1
    errs = {"float32": 0.0, "bfloat16": 0.0, "float16": 0.0, "int8": 0.0}
    n_checked = 0
    variants = {}  # (m, K, O, xdtype) -> the variant the C entry point took
    for (M, K, O, _) in counts:
        for m in (M, 1, 37):
            for xdtype in errs:
                for bias in (False, True):
                    xin, wq, scale, b = operands(m, K, O, xdtype, bias, gen,
                                                 device)
                    got = int8_gemm.launch(xin, wq, scale, b)
                    variants[m, K, O, xdtype] = int8_gemm.last_variant
                    want = int8_matmul_reference(xin, wq, scale, b)
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    errs[xdtype] = max(errs[xdtype], err)
                    n_checked += 1
                    if xdtype == "int8":
                        if not torch.equal(got, want):
                            raise AssertionError(
                                f"dynamic kernel not bitwise at M={m} K={K} "
                                f"O={O} bias={bias}: max err {err}")
                    else:
                        torch.testing.assert_close(
                            got, want, rtol=1e-5,
                            atol=1e-5 * want.abs().max().item(),
                            msg=lambda e: f"{xdtype} M={m} K={K} O={O}: {e}")
                    del xin, wq, scale, b, got, want
    # x from a base one element off its boundary: TMA cannot take it, so
    # every shape goes to the mma variant, with narrower loads
    n_shifted = 0
    for (M, K, O, _) in counts:
        for xdtype in errs:
            mode = "dynamic" if xdtype == "int8" else "weight_only"
            xin, wq, scale, b = operands(37, K, O, xdtype, True, gen, device)
            buf = torch.empty(xin.numel() + 1, dtype=xin.dtype, device=device)
            shifted = buf[1:].view(xin.shape)
            shifted.copy_(xin)
            got = int8_gemm.launch(shifted, wq, scale, b)
            variant = int8_gemm.last_variant[0]
            want = int8_matmul_reference(xin, wq, scale, b)
            torch.cuda.synchronize()
            if variant != f"mma_{mode}":
                raise AssertionError(f"an unaligned base at K={K} O={O} x "
                                     f"{xdtype} took {variant}")
            err = (got - want).abs().max().item()
            errs[xdtype] = max(errs[xdtype], err)
            if xdtype == "int8" and not torch.equal(got, want):
                raise AssertionError(f"dynamic kernel not bitwise from an "
                                     f"unaligned base at K={K} O={O}: {err}")
            if xdtype != "int8":
                torch.testing.assert_close(
                    got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item(),
                    msg=lambda e: f"{xdtype} unaligned K={K} O={O}: {e}")
            n_shifted += 1
            del xin, buf, shifted, wq, scale, b, got, want
    print(f"kernel check: {n_checked} GEMMs vs int8_matmul_reference and "
          f"{n_shifted} from an unaligned base (mma); dynamic bitwise; max "
          f"abs err f32 {errs['float32']:.3e} bf16 {errs['bfloat16']:.3e} "
          f"f16 {errs['float16']:.3e} int8 {errs['int8']:.3e}")
    taken = {}
    for (m, K, O, xdtype), v in variants.items():
        taken.setdefault((xdtype, v[0]), []).append(f"{m}x{K}x{O}")
    for (xdtype, v), cases in sorted(taken.items()):
        print(f"  x {xdtype} variant {v}: {len(cases)} checked shapes "
              f"({', '.join(cases[:6])}{', ...' if len(cases) > 6 else ''})")

    totals = {}
    for (M, K, O, bias), n in counts.items():
        # bf16 rows too where the mma variant takes the shape (its row
        # stands beside the forward's, outside the totals)
        for xdtype in ("float32", "int8") + (("bfloat16",) if K % 16 else ()):
            mode = "dynamic" if xdtype == "int8" else "weight_only"
            xin, wq, scale, b = operands(M, K, O, xdtype, bias, gen, device)
            k_fn = lambda: int8_gemm.launch(xin, wq, scale, b)  # noqa: E731
            lib = library_call(xin, wq, scale, b, xdtype,
                               dequantized_library)
            # device time (torch.profiler): the kernel and the library call
            # in one session, told apart by the kernels' names
            k_ms, l_ms = gemm_device_ms(k_fn, lib)
            # dynamic against the dequantized addmm: _int_mm beside it
            i_fn = int_mm_call(xin, wq) if mode == "dynamic" and \
                dequantized_library else None
            i_ms = gemm_device_ms(k_fn, i_fn)[1] if i_fn is not None else None
            i_ev = cuda_ms(i_fn) if i_fn is not None else None
            variant = int8_gemm.last_variant
            # event-timed loops, the host's launch gaps included
            k_ev = cuda_ms(k_fn)
            p_ev = cuda_ms(lambda: int8_matmul_reference(xin, wq, scale, b),
                           budget_ms=10.0)
            l_ev = cuda_ms(lib) if lib is not None else None
            b_ms, b_by, peak = bound(M, K, O, bias, xdtype)
            c_ms = bound(M, K, O, bias, xdtype, cuda_cores=True)[0]
            row = {"mode": mode, "x": xdtype, "M": M, "K": K, "O": O,
                   "bias": bias, "launches_per_forward": n,
                   "variant": list(variant), "kernel_ms": k_ms,
                   "library_ms": l_ms, "kernel_event_ms": k_ev,
                   "plain_event_ms": p_ev, "library_event_ms": l_ev,
                   "bound_ms": b_ms, "bound_by": b_by, "peak": peak}
            if mode == "weight_only":
                row["bound_cuda_cores_ms"] = c_ms
            if i_fn is not None:
                row["int_mm_ms"], row["int_mm_event_ms"] = i_ms, i_ev
            report["shapes"].append(row)
            fmt = lambda v: "n/a" if v is None else f"{v:.4f}"  # noqa: E731
            cores = (f", CUDA cores {c_ms:.4f}" if mode == "weight_only"
                     else "")
            int_mm = (f" _int_mm={i_ms:.4f} [{i_ev:.4f}]" if i_fn is not None
                      else "")
            print(f"gemm {mode:11s}{' bf16 rows' if xdtype == 'bfloat16' else ''}"
                  f" M={M:6d} K={K:4d} O={O:4d} "
                  f"bias={int(bias)} x{n} {variant[0]} tile {variant[1]}x"
                  f"{variant[2]} stages {variant[3]} blocks {variant[4]}: "
                  f"device ms kernel={k_ms:.4f} library={fmt(l_ms)}{int_mm} "
                  f"bound={b_ms:.4f} ({b_by}, peak {peak / 1e12:.0f}T"
                  f"{cores}); event-timed kernel={k_ev:.4f} "
                  f"plain={p_ev:.4f} library={fmt(l_ev)} [{card}]")
            if xdtype == "bfloat16":
                del xin, wq, scale, b
                continue
            t = totals.setdefault(mode, {
                "ms": 0.0, "event_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "bound_cuda_cores_ms": 0.0, "library_ms": 0.0,
                "library_event_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                "int_mm_ms": 0.0, "variants": {}})
            t["ms"] += n * k_ms
            # where _int_mm refuses a shape (the Dense head's O=20), its
            # dequantized addmm stands in the forward's sum
            alt = i_ms if i_ms is not None else l_ms
            t["int_mm_ms"] = None if not (dequantized_library and mode ==
                                          "dynamic") or alt is None \
                or t["int_mm_ms"] is None else t["int_mm_ms"] + n * alt
            t["event_ms"] += n * k_ev
            t["plain_ms"] += n * p_ev
            t["bound_ms"] += n * b_ms
            t["bound_cuda_cores_ms"] += n * c_ms
            for key, v in (("library_ms", l_ms), ("library_event_ms", l_ev)):
                t[key] = None if v is None or t[key] is None \
                    else t[key] + n * v
            t["bytes_ms" if b_by == "bytes" else "ops_ms"] += n * b_ms
            t["variants"][variant[0]] = t["variants"].get(variant[0], 0) + n
            del xin, wq, scale, b
    for mode, t in totals.items():
        lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        if t["int_mm_ms"] is not None and dequantized_library \
                and mode == "dynamic":
            lib += f" _int_mm={t['int_mm_ms']:.4f}"
        cores = (f" (CUDA cores alone {t['bound_cuda_cores_ms']:.4f})"
                 if mode == "weight_only" else "")
        print(f"gemm {mode} per batch-{batch} forward ({sum(counts.values())} "
              f"launches: {t['variants']}): device ms kernel={t['ms']:.4f} "
              f"library={lib} bound={t['bound_ms']:.4f}{cores}; event-timed "
              f"kernel={t['event_ms']:.4f} plain={t['plain_ms']:.4f} "
              f"[{card}]")
    for mode, t in totals.items():
        t["max_abs_err"] = errs["int8" if mode == "dynamic" else "float32"]
    return totals


def device_time(prof):
    """(device busy ms, kernels, ops) of a torch.profiler run, each of the
    two a [(name, device ms, calls)] list by time.  Busy is the sum over
    the kernel-side events (each launch counted once).  The ops are the
    host-side aten operations that launched kernels and carry the same
    device time; the port's own kernels, launched through ctypes, appear
    only among the kernels.  The :func:`sentinel` spin and the device
    spans of ``record_function`` ranges (user annotations, idle gaps
    included) are left out."""
    from torch.autograd import DeviceType
    events = prof.key_averages()

    def by_time(kind):
        return sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                       for e in events if e.device_type == kind
                       and e.self_device_time_total > 0
                       and not getattr(e, "is_user_annotation", False)
                       and "spin_kernel" not in e.key
                       and e.key != "aten::_sleep"),
                      key=lambda t: -t[1])
    kernels = by_time(DeviceType.CUDA)
    return sum(ms for _, ms, _ in kernels), kernels, by_time(DeviceType.CPU)


def profile_step(step, label, card, top):
    """One call of ``step`` (a training step) under torch.profiler after a
    warm-up call: prints (:func:`print_profile`, the ``top`` kernels and
    operations) and returns wall ms, device busy ms, the idle share, kernel
    launches and the 20 first device kernels and aten operations."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.monotonic()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t1) * 1e3
    busy_ms, kernels, ops = device_time(prof)
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": max(0.0, 1 - busy_ms / wall_ms) if busy_ms
           else None,
           "kernel_launches": sum(n for _, _, n in kernels),
           "kernels": [list(k) for k in kernels[:20]],
           "ops": [list(o) for o in ops[:20]]}
    print_profile(label, out, card, top)
    return out


def print_profile(label, prof, card, top=None):
    """Prints a profile (:func:`profile_step`, :func:`profiled_block`):
    wall ms, device busy ms, the idle share, kernel launches and the
    ``top`` device kernels and aten operations (all it holds: None)."""
    idle = "not measured (the profiler saw no device time)" \
        if not prof.get("device_busy_ms") else f"{prof['idle_share']:.3f}"
    print(f"profile {label}: wall_ms={prof['wall_ms']:.2f} device_busy_ms="
          f"{prof['device_busy_ms']:.2f} idle_share={idle} kernel_launches="
          f"{prof['kernel_launches']} [{card}]")
    busy = prof["device_busy_ms"]
    for name, ms, n in (prof["kernels"][:top]
                        + [["--- aten ops ---", 0.0, 0]] + prof["ops"][:top]):
        share = 100 * ms / busy if busy else 0.0
        print(f"  {ms:8.3f} ms {share:5.1f}% x{n:<5d} {name[:90]}")


def profile_phase(mode, seed, device, card, report):
    """Where one batch-32 forward's time goes: torch.profiler's device
    time by kernel over one forward after a warmup, against the forward's
    host-clock wall time (device idle share = 1 - busy / wall)."""
    from torch.profiler import ProfilerActivity, profile
    model = quantize(resnet50().initialize(seed), mode=mode).to(device)
    x = torch.randn((BATCH,) + SPEC[0], device=device)
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            model(x)
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
    busy_ms, kernels, ops = device_time(prof)
    gemm_ms = sum(ms for name, ms, _ in kernels if "gemm_" in name)
    if busy_ms == 0:
        print(f"profile {mode}: the profiler saw no device time; device "
              f"breakdown not measured (wall_ms={wall_ms:.2f}) [{card}]")
        report["profile"][mode] = {"wall_ms": wall_ms, "device": None}
        return
    print(f"profile {mode} batch {BATCH}: wall_ms={wall_ms:.2f} "
          f"device_busy_ms={busy_ms:.2f} idle_share="
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}; int8_gemm {gemm_ms:.3f} "
          f"ms ({100 * gemm_ms / busy_ms:.1f}%) [{card}]")
    for name, ms, n in ops[:8]:
        print(f"  {ms:8.3f} ms {100 * ms / busy_ms:5.1f}% x{n:<4d} {name}")
    report["profile"][mode] = {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms, "int8_gemm_ms": gemm_ms,
        "ops": {name: {"ms": ms, "count": n} for name, ms, n in ops}}


def serving_phase(mode, seed, device, card, report):
    model = resnet50().initialize(torch.Generator().manual_seed(seed))
    torch.cuda.reset_peak_memory_stats()
    with ModelRegistry(device=device) as reg:
        t0 = time.monotonic()
        svc = reg.deploy("resnet50", model, input_spec=SPEC, max_batch_size=BATCH,
                         quantize=True if mode == "weight_only" else mode)
        deploy_s = time.monotonic() - t0
        warm = svc.compile_count
        if warm != len(svc.buckets):
            raise AssertionError(f"warmup ran {warm} forwards for "
                                 f"{len(svc.buckets)} buckets")
        errors = []

        def client(tid):
            rng = np.random.default_rng(seed * 100 + tid)
            try:
                for _ in range(16):
                    x = rng.normal(0, 1, (int(rng.integers(1, 5)),)
                                   + SPEC[0]).astype(np.float32)
                    y = reg.predict("resnet50", x, timeout=300)
                    if y.shape != (len(x), 1000) or not np.isfinite(y).all():
                        raise AssertionError(f"bad output {y.shape}")
            except Exception as e:  # re-raised below
                errors.append(e)

        int8_gemm.reset_counts()
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(8)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.monotonic() - t0
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError(f"client failures: {errors[:3]}")
        stats = svc.stats()
        # the 4 sampled requests go alone: in dynamic mode the activation
        # scale is per dispatched batch, so a coalesced request's output
        # depends on its neighbours and only a lone one has a CPU twin
        rng = np.random.default_rng(seed)
        samples = [rng.normal(0, 1, (int(rng.integers(1, 5)),)
                              + SPEC[0]).astype(np.float32) for _ in range(4)]
        served = [reg.predict("resnet50", x, timeout=300) for x in samples]
        launches = int8_gemm.launches
        variants = {v: n for v, n in int8_gemm.variant_launches.items() if n}
        dispatches = svc.stats()["dispatch_count"]
        peak_mem = torch.cuda.max_memory_allocated()
    if launches != 54 * dispatches or dispatches == 0:
        raise AssertionError(f"{mode}: {launches} kernel launches for "
                             f"{dispatches} dispatches (want 54 each)")
    # the stem's K=147 int8 weight rows are no 16-byte multiple, so it takes
    # the mma variant; the 53 others the wgmma one
    want = {f"mma_{mode}": dispatches, f"wgmma_{mode}": 53 * dispatches}
    if variants != want:
        raise AssertionError(f"{mode}: variant launches {variants}, want "
                             f"{want}")
    if stats["compile_count"] != warm or stats["requests_failed"]:
        raise AssertionError(f"{mode}: warmup grew or requests failed: "
                             f"{stats}")
    cpu_model = quantize(model, mode=mode)
    with torch.inference_mode():
        wants = [cpu_model(torch.from_numpy(x)).numpy() for x in samples]
    for y, want in zip(served, wants):
        np.testing.assert_allclose(
            y, want, rtol=SERVE_TOL[mode],
            atol=SERVE_TOL[mode] * np.abs(want).max())
    worst = max(rel_err(y, want) for y, want in zip(served, wants))
    faults = planted_fault_errors(model, mode, samples, wants, device)
    for fault, err in faults.items():
        if not err > SERVE_TOL[mode]:
            raise AssertionError(
                f"{mode}: planted fault {fault} reads {err:.3e}, inside the "
                f"served tolerance {SERVE_TOL[mode]}: the check is blind")
    print(f"served-vs-cpu check {mode}: sound {worst:.3e}, planted faults "
          + ", ".join(f"{k} {v:.3e}" for k, v in faults.items())
          + f" (tol {SERVE_TOL[mode]}) [{card}]")
    lat = stats["latency_ms"]
    print(f"serve {mode}: {stats['requests_completed']} rows in "
          f"{stats['dispatch_count']} coalesced dispatches + 4 lone; "
          f"{launches} kernel launches for {dispatches} dispatches "
          f"({variants}), "
          f"throughput_rps={stats['throughput_rps']} "
          f"p50_ms={lat['p50']} p99_ms={lat['p99']} "
          f"occupancy={stats['mean_batch_occupancy']} "
          f"compile_count={stats['compile_count']} deploy_s={deploy_s:.2f} "
          f"wall_s={wall:.2f} max_memory_allocated={peak_mem} "
          f"cpu_rel_err={worst:.3e} (tol {SERVE_TOL[mode]}) [{card}]")
    report["serving"][mode] = {
        "stats": stats, "launches": launches, "variant_launches": variants,
        "deploy_s": deploy_s,
        "wall_s": wall, "max_memory_allocated": peak_mem,
        "cpu_rel_err": worst, "planted_fault_rel_err": faults}
    return launches


def rel_err(y, want) -> float:
    return float(np.abs(y - want).max() / np.abs(want).max())


def planted_fault_errors(model, mode, samples, wants, device):
    """{fault: largest error, as a share of max|y|, of the quantized
    ``model`` run on the card with that fault planted, against the sound
    CPU outputs ``wants``}.  The faults: every quantized layer's input
    rounded to bf16, and one mid-network conv's weight scales off by
    127/128 (a quantizer that divides by 128)."""
    out = {}
    for fault in ("bf16_activations", "one_scale_127_128"):
        qm = quantize(model, mode=mode).to(device)
        layers = [m for m in qm.modules() if isinstance(
            m, (QuantizedSpatialConvolution, QuantizedLinear))]
        if fault == "bf16_activations":
            for m in layers:
                m.register_forward_pre_hook(
                    lambda m, args: (args[0].bfloat16().float(),))
        else:
            layers[len(layers) // 2].weight_scale.mul_(127 / 128)
        with torch.inference_mode():
            out[fault] = max(
                rel_err(qm(torch.from_numpy(x).to(device)).cpu().numpy(), w)
                for x, w in zip(samples, wants))
        del qm
    return out


# ------------------------------------------------------------- LSTM cell
def cell_operands(N, H, dtype, gen, device):
    """zx, h, c, w_t, dh, dc at (N, H), N(0, 0.5^2), in ``dtype``."""
    mk = lambda *s: (0.5 * torch.randn(*s, generator=gen,  # noqa: E731
                                       device=device)).to(dtype)
    return (mk(N, 4 * H), mk(N, H), mk(N, H), mk(H, 4 * H), mk(N, H),
            mk(N, H))


def cell_bound(N, H, dtype, kernel):
    """(least ms, "bytes" | "operations") of one launch: each input read
    once and each output written once, against the card's memory rate and
    the f32 CUDA-core peak.  Operations: the forward's recurrent product
    (2*N*H*4H) plus the elementwise chain, counted as CELL_EW_OPS per
    hidden unit (a transcendental function counts as one)."""
    es = torch.tensor([], dtype=dtype).element_size()
    NH, G = N * H, 4 * N * H
    if kernel == "lstm_cell_fwd":  # zx, h, c, w_t in; h', c', z out
        nbytes = es * (G + 2 * NH + 4 * H * H) + es * 2 * NH + 4 * G
        ops = 2 * NH * 4 * H + CELL_EW_OPS[kernel] * NH
    else:  # z, c, dh, dc in; dz, dc_prev out
        nbytes = 4 * G + es * 3 * NH + 4 * G + es * NH
        ops = CELL_EW_OPS[kernel] * NH
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def cell_check(shapes, device, card, gen, dtypes=("float32", "bfloat16")):
    """B2f and B2b against their plain versions at every (N, H) of
    ``shapes``, in each of ``dtypes`` (f32 and bf16 by default), forget_bias
    0 and 1: {(N, H): {(kernel, dtype): max abs err}}."""
    errs = {}
    for N, H in shapes:
        errs[N, H] = at = {(k, d): 0.0 for k in LSTM_KERNELS for d in dtypes}
        for dname in dtypes:
            dtype = getattr(torch, dname)
            for fb in (0.0, 1.0):
                zx, h, c, w_t, dh, dc = cell_operands(N, H, dtype, gen, device)
                got = lstm_cell.launch_fwd(zx, h, c, w_t, fb)
                want = lstm_cell.lstm_cell_fwd_reference(zx, h, c, w_t, fb)
                # the backward of both from the kernel's own z
                got_b = lstm_cell.launch_bwd(got[2], c, dh, dc, fb)
                want_b = lstm_cell.lstm_cell_bwd_reference(got[2], c, dh, dc,
                                                           fb)
                torch.cuda.synchronize()
                for kernel, gs, ws in (("lstm_cell_fwd", got, want),
                                       ("lstm_cell_bwd", got_b, want_b)):
                    for g, w in zip(gs, ws):
                        tol = cell_tol(kernel, H, g.dtype)
                        torch.testing.assert_close(
                            g.float(), w.float(), rtol=tol, atol=tol,
                            msg=lambda e: f"{kernel} N={N} H={H} {dname} "
                                          f"fb={fb}: {e}")
                        at[kernel, dname] = max(
                            at[kernel, dname],
                            (g.float() - w.float()).abs().max().item())
    worst = {key: max(e[key] for e in errs.values())
             for key in next(iter(errs.values()))}
    print(f"lstm kernel check: B2f and B2b at {2 * len(dtypes) * len(shapes)} "
          f"(shape, dtype, forget_bias) cases vs their plain versions, shapes "
          f"{list(shapes)}; max abs err "
          + ", ".join(f"{k} {d} {v:.3e}" for (k, d), v in worst.items())
          + f" (tol {CELL_TOL}) [{card}]")
    return errs


def cell_time_rows(N, H, errs, device, card, gen, dtype=torch.float32):
    """Kernel, plain and library times of B2f and B2b at (N, H) in
    ``dtype`` (f32 by default), W_t warm in L2 as the steps of a sequence
    find it: device time per call (torch.profiler) and, beside it, a
    CUDA-event-timed loop that includes the host's launch gaps; with the
    bound and the errors ``errs`` of :func:`cell_check` at that shape.
    {kernel: row}."""
    dname = str(dtype).split(".")[1]
    zx, h, c, w_t, dh, dc = cell_operands(N, H, dtype, gen, device)
    # PyTorch's fused cell takes both biases or neither (its CUDA version
    # reads the hidden bias's strides when the input bias is given);
    # forget_bias, 0 here, would go in the input bias's f segment
    ib, hb = (torch.zeros(4 * H, device=device, dtype=dtype)
              for _ in range(2))
    _, _, z = lstm_cell.launch_fwd(zx, h, c, w_t, 0.0)
    hy, cy, ws = torch.ops.aten._thnn_fused_lstm_cell(zx, h @ w_t, c, ib, hb)
    ref = lstm_cell.lstm_cell_fwd_reference(zx, h, c, w_t, 0.0)
    # a 16-bit library call rounds h @ w_t to its type before the gates:
    # the same function within 1e-2 (a yardstick, not a check of B2f)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close((hy.float(), cy.float()),
                               (ref[0].float(), ref[1].float()), rtol=tol,
                               atol=tol)
    fns = {
        "lstm_cell_fwd": (
            lambda: lstm_cell.launch_fwd(zx, h, c, w_t, 0.0),
            lambda: lstm_cell.lstm_cell_fwd_reference(zx, h, c, w_t, 0.0),
            lambda: torch.ops.aten._thnn_fused_lstm_cell(
                zx, torch.mm(h, w_t), c, ib, hb),
            "2 calls: torch.mm(h, w_t) + torch._thnn_fused_lstm_cell"),
        "lstm_cell_bwd": (
            lambda: lstm_cell.launch_bwd(z, c, dh, dc, 0.0),
            lambda: lstm_cell.lstm_cell_bwd_reference(z, c, dh, dc, 0.0),
            lambda: torch.ops.aten._thnn_fused_lstm_cell_backward_impl(
                dh, dc, c, cy, ws, True),
            "torch._thnn_fused_lstm_cell_backward_impl (workspace of "
            "activated gates, not z)")}
    rows = {}
    for kernel, (k_fn, p_fn, l_fn, l_what) in fns.items():
        # ms: device time per call; event_ms: a loop of calls timed with
        # CUDA events, host launch gaps included
        k_ms, p_ms, l_ms = (device_ms(f) for f in (k_fn, p_fn, l_fn))
        k_ev, p_ev, l_ev = (cuda_ms(f) for f in (k_fn, p_fn, l_fn))
        b_ms, b_by = cell_bound(N, H, dtype, kernel)
        rows[kernel] = {"shape": [N, H], "ms": k_ms, "plain_ms": p_ms,
                        "library_ms": l_ms, "library_call": l_what,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "max_abs_err": errs[kernel, dname],
                        "event_ms": k_ev, "plain_event_ms": p_ev,
                        "library_event_ms": l_ev}
        if (kernel, "bfloat16") in errs and dname != "bfloat16":
            rows[kernel]["max_abs_err_bf16"] = errs[kernel, "bfloat16"]
        grid = ""
        if kernel == "lstm_cell_fwd":
            ctas, cluster, copy_bytes, tile = lstm_cell.last_fwd_shape
            rows[kernel].update(ctas=ctas, cluster=cluster,
                                copy_bytes=copy_bytes)
            grid = (f" [{ctas} CTAs in clusters of {cluster}, "
                    f"{copy_bytes}-byte copies, batch tile {tile}]")
        else:  # the floor: an empty kernel of B2b's grid, timed alike
            blocks, threads = lstm_cell.last_bwd_shape
            if lstm_cell.launch_bwd_empty(z, c, dh, dc) != (blocks, threads):
                raise AssertionError("the empty kernel's grid is not B2b's")
            f_ms = device_ms(lambda: lstm_cell.launch_bwd_empty(z, c, dh,
                                                                dc))
            rows[kernel].update(blocks=blocks, threads=threads,
                                floor_ms=f_ms)
            grid = (f" [{blocks} blocks of {threads} threads, one hidden "
                    f"unit a thread; floor_ms={f_ms:.5f} (an empty kernel "
                    f"of that grid), kernel/floor {k_ms / f_ms:.3f}]")
        beats = " (faster than its HBM bound: W_t is read from L2)" \
            if k_ms < b_ms else ""
        print(f"{kernel} N={N} H={H} {dname}{grid}, device ms per call: "
              f"kernel_ms={k_ms:.5f} plain_ms={p_ms:.5f} "
              f"library_ms={l_ms:.5f} [{l_what}] bound_ms={b_ms:.5f} "
              f"({b_by}){beats}; event-timed loop with host launch gaps: "
              f"kernel {k_ev:.5f} plain {p_ev:.5f} library {l_ev:.5f} "
              f"[{card}]")
    return rows


def lstm_kernel_phase(device, card, report):
    """B2f and B2b against their plain versions at every shape, dtype and
    forget_bias of CELL_SHAPES, then kernel, plain and library times at
    PTB-medium's (20, 650) and PTB-small's (20, 200) f32
    (:func:`cell_time_rows`).  ({kernel: row at (20, 650)}, {kernel: row
    at (20, 200)})."""
    gen = torch.Generator(device=device).manual_seed(4321)
    errs = cell_check(CELL_SHAPES, device, card, gen)
    medium = (PTB["batch"], PTB["hidden"])
    small = (PTB_SMALL["batch"], PTB_SMALL["hidden"])
    rows = cell_time_rows(*medium, errs[medium], device, card, gen)
    small_rows = cell_time_rows(*small, errs[small], device, card, gen)
    report["lstm_kernels"] = rows
    report["lstm_kernels_ptb_small"] = small_rows
    return rows, small_rows


# ------------------------------------------------------- PTB-medium training
def ptb_samples(seed):
    """(x, next-word) windows of T words from the synthetic Zipf corpus of
    examples/languagemodel/train_ptb.py at vocab 10000: PTB_BATCHES
    batches of 20 per epoch."""
    rng = np.random.default_rng(seed)
    n = PTB["batch"] * PTB["T"] * PTB_BATCHES + 1
    words = [f"w{min(int(z), PTB['vocab'] - 2)}" for z in rng.zipf(1.4, n)]
    ids = Dictionary([words], vocab_size=PTB["vocab"]).encode(words)
    T = PTB["T"]
    xs, ys = ids[:-1].reshape(-1, T), ids[1:].reshape(-1, T)
    return [Sample(x, y) for x, y in zip(xs, ys)]


def ptb_train(model, device, steps, samples, seed):
    """Train ``model`` in place for ``steps`` steps of the PTB-medium recipe
    through LocalOptimizer; (per-step losses, optimizer, wall seconds)."""
    losses = []

    class Recording(LocalOptimizer):
        def _log_train_iteration(self, lr):
            losses.append(self.state["loss"])

    opt = (Recording(model, DataSet.array(samples, seed=seed)
                     >> SampleToMiniBatch(PTB["batch"]),
                     nn.TimeDistributedCriterion(nn.ClassNLLCriterion()),
                     device=device)
           .set_optim_method(optim.SGD(learning_rate=1.0))
           .set_gradient_clipping_by_l2_norm(5.0)
           .set_steps_per_dispatch(PTB["K"])
           .set_seed(seed)
           .set_end_when(optim.max_iteration(steps)))
    t0 = time.monotonic()
    opt.optimize()
    return losses, opt, time.monotonic() - t0


def flat_params(model):
    return {k: p.detach().cpu().double() for k, p in model.named_parameters()}


def train_reading(losses, model, want_losses, want, init):
    """How far a run is from the CPU run: the larger of the largest
    relative loss difference over the steps and, over the parameter
    arrays, the largest difference as a share of the largest change that
    training made to that array on the CPU."""
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
    got = flat_params(model)
    param_err = max(((got[k] - want[k]).abs().max()
                     / (want[k] - init[k]).abs().max()).item() for k in want)
    return max(loss_err, param_err)


def planted_lstm_fault(fault, T=PTB["T"]):
    """A wrapper of the fused cell as the LSTM layer calls it, planting
    ``fault`` on the card run: layer 0's W_t scaled by 127/128, or one
    time step's layer-0 dz (the gradient reaching zx_t) scaled by 127/128
    through a tensor hook (sequences of ``T`` steps)."""
    sound = recurrent.lstm_cell
    calls = [0]

    def cell(zx, h, c, w_t, **kw):
        if fault == "w_t_127_128":
            return sound(zx, h, c, w_t * (127 / 128), **kw)
        calls[0] += 1
        if calls[0] % T == T // 2:
            zx.register_hook(lambda g: g * (127 / 128))
        return sound(zx, h, c, w_t, **kw)
    return cell


def training_phase(seed, device, card, report):
    """PTB-medium trained through LocalOptimizer on the card: one K=8
    block against the same steps on the CPU (and two planted faults), then
    timed blocks, the launch counts, peak memory and one profiled step."""
    samples = ptb_samples(seed)
    init = ptb_model(PTB["vocab"], PTB["embed"], PTB["hidden"],
                     PTB["layers"]).initialize(seed)
    start = flat_params(init)
    K = PTB["K"]

    t0 = time.monotonic()
    cpu_model = copy.deepcopy(init)
    cpu_losses, _, cpu_s = ptb_train(cpu_model, "cpu", K, samples, seed)
    want = flat_params(cpu_model)
    card_model = copy.deepcopy(init)
    card_losses, _, _ = ptb_train(card_model, device, K, samples, seed)
    sound = train_reading(card_losses, card_model, cpu_losses, want, start)
    faults = {}
    for fault in ("w_t_127_128", "one_step_dz_127_128"):
        m = copy.deepcopy(init)
        recurrent.lstm_cell = planted_lstm_fault(fault)
        try:
            losses, _, _ = ptb_train(m, device, K, samples, seed)
        finally:
            recurrent.lstm_cell = lstm_cell.lstm_cell
        faults[fault] = train_reading(losses, m, cpu_losses, want, start)
    print(f"train-vs-cpu check, {K} steps: sound {sound:.3e}, planted faults "
          + ", ".join(f"{k} {v:.3e}" for k, v in faults.items())
          + f" (tol {TRAIN_TOL}); cpu losses {cpu_losses[0]:.4f} -> "
          f"{cpu_losses[-1]:.4f} in {cpu_s:.1f} s [{card}]")
    if not sound <= TRAIN_TOL:
        raise AssertionError(f"card training is {sound:.3e} from the CPU, "
                             f"over the limit {TRAIN_TOL}")
    for fault, err in faults.items():
        if not err > TRAIN_TOL:
            raise AssertionError(
                f"planted fault {fault} reads {err:.3e}, inside the training "
                f"tolerance {TRAIN_TOL}: the check is blind")
    print(f"phase train-vs-cpu: {time.monotonic() - t0:.1f} s")

    t0 = time.monotonic()
    ptb_train(copy.deepcopy(init), device, K, samples, seed)  # warm-up
    _, _, one_s = ptb_train(copy.deepcopy(init), device, K, samples, seed)
    steps = K * (1 + TIMED_BLOCKS)
    torch.cuda.reset_peak_memory_stats()
    lstm_cell.fwd_launches = lstm_cell.bwd_launches = 0
    losses, opt, all_s = ptb_train(copy.deepcopy(init), device, steps,
                                   samples, seed)
    launches = {"lstm_cell_fwd": lstm_cell.fwd_launches,
                "lstm_cell_bwd": lstm_cell.bwd_launches}
    peak = torch.cuda.max_memory_allocated()
    for kernel, n in launches.items():
        if n != PTB["T"] * steps:
            raise AssertionError(f"{kernel} launched {n} times in {steps} "
                                 f"steps (want {PTB['T']} a step)")
    if not np.mean(losses[-K:]) < np.mean(losses[:K]):
        raise AssertionError(f"the loss did not fall: {losses}")
    step_s = (all_s - one_s) / (steps - K)
    words = PTB["batch"] * PTB["T"]
    print(f"train ptb-medium K={K}: {steps} steps in {all_s:.3f} s, {K} in "
          f"{one_s:.3f} s (each run includes the model's copy to and from "
          f"the card); the {TIMED_BLOCKS} later blocks: "
          f"ms_per_step={step_s * 1e3:.3f} words_per_s={words / step_s:.1f} "
          f"max_memory_allocated={peak} loss {np.mean(losses[:K]):.4f} -> "
          f"{np.mean(losses[-K:]):.4f}; launches {launches} "
          f"(allow_tf32 False) [{card}]")
    print(f"phase train-timed: {time.monotonic() - t0:.1f} s")

    # one step of the same recipe, profiled after a warm-up step
    net = copy.deepcopy(init).to(device).train()
    params = dict(net.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion())
    sgd = optim.SGD(learning_rate=1.0)
    x = torch.from_numpy(np.stack([s.feature for s in samples[:20]])).to(
        device)
    y = torch.from_numpy(np.stack([s.label for s in samples[:20]])).to(
        device)

    def step():
        for p in params.values():
            p.grad = None
        crit.apply(net(x), y).backward()
        grads = optim.clip_by_global_norm(
            {k: p.grad for k, p in params.items()}, 5.0)
        sgd.update(grads, params, {}, 1.0, 0)

    prof = profile_step(step, "train step", card, 6)
    report["training"] = {
        "sound": sound, "planted_faults": faults, "tol": TRAIN_TOL,
        "cpu_losses": cpu_losses, "card_losses": card_losses,
        "timed_losses": losses, "steps": steps, "all_s": all_s,
        "one_block_s": one_s, "ms_per_step": step_s * 1e3,
        "words_per_s": words / step_s, "max_memory_allocated": peak,
        "launches": launches, "profile": prof}
    del net, params
    return launches


# ------------------------------------------------------------- max-pool B1
POOL_KERNEL = {"route": "cuda", "source": "bigdl_tpu_torch/csrc/maxpool_bwd.cu",
               "replaces": "bigdl_tpu/ops/pallas_pool.py:165"}
# (name, (N, C, H, W), kernel, stride, pad, ceil_mode, format, dtype, input),
# kernel, stride and pad an int or (h, w): ResNet-50's stem at batch 256 in
# both formats and dtypes, its post-ReLU case, LeNet/VGG's 2x2/2, Inception's
# 3x3/1 pad 1, a ceil-mode odd size, ragged channel counts, and the kernel's
# other branches: a 5x3 window with unequal pads and a 1x1/2 (the loops), a
# 16x16 window (int32 offsets), and a view whose storage spans 2^31 elements
# or more (64-bit indices), at the stem's window in both formats and at the
# loops'.  "ints":
# integer values in [-4, 4], so windows hold exact ties; "relu": max(N(0,
# 1), 0), half of it an exact 0; "wide": ints in a strided view of a 2^31 +
# N*H*W*C element buffer.
POOL_CASES = [
    ("stem_nhwc_f32", (256, 64, 112, 112), 3, 2, 1, False, "NHWC",
     torch.float32, "ints"),
    ("stem_nhwc_bf16", (256, 64, 112, 112), 3, 2, 1, False, "NHWC",
     torch.bfloat16, "ints"),
    ("stem_nchw_f32", (256, 64, 112, 112), 3, 2, 1, False, "NCHW",
     torch.float32, "ints"),
    ("stem_nhwc_bf16_relu", (256, 64, 112, 112), 3, 2, 1, False, "NHWC",
     torch.bfloat16, "relu"),
    ("2x2s2_nchw_f32", (32, 64, 56, 56), 2, 2, 0, False, "NCHW",
     torch.float32, "ints"),
    ("3x3s1p1_nhwc_bf16", (32, 192, 28, 28), 3, 1, 1, False, "NHWC",
     torch.bfloat16, "ints"),
    ("3x3s2_ceil_odd_nhwc_f32", (8, 64, 27, 27), 3, 2, 0, True, "NHWC",
     torch.float32, "ints"),
    ("3x3s2p1_c3_nhwc_f32", (8, 3, 33, 33), 3, 2, 1, False, "NHWC",
     torch.float32, "ints"),
    ("3x3s2p1_c160_nhwc_bf16", (8, 160, 14, 14), 3, 2, 1, False, "NHWC",
     torch.bfloat16, "ints"),
    ("5x3s2p2x1_nhwc_f32", (8, 64, 29, 30), (5, 3), 2, (2, 1), False, "NHWC",
     torch.float32, "ints"),
    ("5x3s2p2x1_nchw_bf16", (8, 64, 29, 30), (5, 3), 2, (2, 1), False,
     "NCHW", torch.bfloat16, "ints"),
    ("1x1s2_nhwc_bf16", (8, 64, 28, 28), 1, 2, 0, False, "NHWC",
     torch.bfloat16, "ints"),
    ("16x16s8_nhwc_f32", (4, 64, 64, 64), 16, 8, 0, False, "NHWC",
     torch.float32, "ints"),
    ("16x16s8_ceil_nchw_bf16", (4, 32, 61, 61), 16, 8, 0, True, "NCHW",
     torch.bfloat16, "ints"),
    ("3x3s2p1_wide_nhwc_bf16", (2, 64, 28, 28), 3, 2, 1, False, "NHWC",
     torch.bfloat16, "wide"),
    ("5x3s2p2x1_wide_nhwc_bf16", (2, 64, 28, 28), (5, 3), 2, (2, 1), False,
     "NHWC", torch.bfloat16, "wide"),
    ("3x3s2p1_wide_nchw_bf16", (2, 64, 28, 28), 3, 2, 1, False, "NCHW",
     torch.bfloat16, "wide"),
    # LeNet-5's two pools at batch 128 (NCHW f32, tiled_nchw)
    ("lenet_pool1_nchw_f32", (128, 6, 24, 24), 2, 2, 0, False, "NCHW",
     torch.float32, "ints"),
    ("lenet_pool2_nchw_f32", (128, 12, 8, 8), 2, 2, 0, False, "NCHW",
     torch.float32, "ints"),
    # the same two pools at batch 64, a process's batch in the world-2
    # DistriOptimizer check
    ("lenet_b64_pool1_nchw_f32", (64, 6, 24, 24), 2, 2, 0, False, "NCHW",
     torch.float32, "ints"),
    ("lenet_b64_pool2_nchw_f32", (64, 12, 8, 8), 2, 2, 0, False, "NCHW",
     torch.float32, "ints"),
    # VGG for CIFAR-10's five 2x2/2 pools at batch 128 (NCHW f32,
    # tiled_nchw)
    ("vgg_pool1_nchw_f32", (128, 64, 32, 32), 2, 2, 0, False, "NCHW",
     torch.float32, "ints"),
    ("vgg_pool2_nchw_f32", (128, 128, 16, 16), 2, 2, 0, False, "NCHW",
     torch.float32, "ints"),
    ("vgg_pool3_nchw_f32", (128, 256, 8, 8), 2, 2, 0, False, "NCHW",
     torch.float32, "ints"),
    ("vgg_pool4_nchw_f32", (128, 512, 4, 4), 2, 2, 0, False, "NCHW",
     torch.float32, "ints"),
    ("vgg_pool5_nchw_f32", (128, 512, 2, 2), 2, 2, 0, False, "NCHW",
     torch.float32, "ints"),
    # Inception v1's 13 pools at batch 256 (NHWC bf16, tiled_nhwc), its 10
    # distinct geometries: four 3x3/2 ceil-mode pools (the stem's two,
    # pool3, pool4) and the towers' 3x3/1 pad 1 (4b-4d and 5a-5b share one)
    ("inception_pool1_nhwc_bf16", (256, 64, 112, 112), 3, 2, 0, True,
     "NHWC", torch.bfloat16, "ints"),
    ("inception_pool2_nhwc_bf16", (256, 192, 56, 56), 3, 2, 0, True,
     "NHWC", torch.bfloat16, "ints"),
    ("inception_3a_nhwc_bf16", (256, 192, 28, 28), 3, 1, 1, False, "NHWC",
     torch.bfloat16, "ints"),
    ("inception_3b_nhwc_bf16", (256, 256, 28, 28), 3, 1, 1, False, "NHWC",
     torch.bfloat16, "ints"),
    ("inception_pool3_nhwc_bf16", (256, 480, 28, 28), 3, 2, 0, True,
     "NHWC", torch.bfloat16, "ints"),
    ("inception_4a_nhwc_bf16", (256, 480, 14, 14), 3, 1, 1, False, "NHWC",
     torch.bfloat16, "ints"),
    ("inception_4b_nhwc_bf16", (256, 512, 14, 14), 3, 1, 1, False, "NHWC",
     torch.bfloat16, "ints"),
    ("inception_4e_nhwc_bf16", (256, 528, 14, 14), 3, 1, 1, False, "NHWC",
     torch.bfloat16, "ints"),
    ("inception_pool4_nhwc_bf16", (256, 832, 14, 14), 3, 2, 0, True,
     "NHWC", torch.bfloat16, "ints"),
    ("inception_5a_nhwc_bf16", (256, 832, 7, 7), 3, 1, 1, False, "NHWC",
     torch.bfloat16, "ints"),
    # the card-vs-CPU check's Inception v1 (NCHW f32, batch 4, tiled_nchw):
    # a 3x3/2 ceil-mode pool, and 3x3/1 pad 1 pools whose overlapping
    # windows add into one input element, at 28x28 and at the 7x7 edge
    ("inception_check_pool1_nchw_f32", (4, 64, 112, 112), 3, 2, 0, True,
     "NCHW", torch.float32, "ints"),
    ("inception_check_3a_nchw_f32", (4, 192, 28, 28), 3, 1, 1, False,
     "NCHW", torch.float32, "ints"),
    ("inception_check_5a_nchw_f32", (4, 832, 7, 7), 3, 1, 1, False, "NCHW",
     torch.float32, "ints"),
    # f16 (set_compute_dtype(torch.float16)): the stem, LeNet's two pools
    # at batch 128 (the tail phase's f16 LeNet run) and the kernel's other
    # branches in f16: a 3x3/1 pad 1 tile, ragged C, the 5x3 loops, a
    # 16x16 window (int32 offsets), a 2^31-element view (64-bit indices)
    ("stem_nhwc_f16", (256, 64, 112, 112), 3, 2, 1, False, "NHWC",
     torch.float16, "ints"),
    ("stem_nhwc_f16_relu", (256, 64, 112, 112), 3, 2, 1, False, "NHWC",
     torch.float16, "relu"),
    ("lenet_pool1_nchw_f16", (128, 6, 24, 24), 2, 2, 0, False, "NCHW",
     torch.float16, "ints"),
    ("lenet_pool2_nchw_f16", (128, 12, 8, 8), 2, 2, 0, False, "NCHW",
     torch.float16, "ints"),
    ("3x3s1p1_nhwc_f16", (32, 192, 28, 28), 3, 1, 1, False, "NHWC",
     torch.float16, "ints"),
    ("3x3s2p1_c3_nhwc_f16", (8, 3, 33, 33), 3, 2, 1, False, "NHWC",
     torch.float16, "ints"),
    ("5x3s2p2x1_nchw_f16", (8, 64, 29, 30), (5, 3), 2, (2, 1), False,
     "NCHW", torch.float16, "ints"),
    ("16x16s8_nhwc_f16", (4, 64, 64, 64), 16, 8, 0, False, "NHWC",
     torch.float16, "ints"),
    ("3x3s2p1_wide_nhwc_f16", (2, 64, 28, 28), 3, 2, 1, False, "NHWC",
     torch.float16, "wide"),
]
LENET_POOL_CASES = ("lenet_pool1_nchw_f32", "lenet_pool2_nchw_f32")
DISTRI_POOL_CASES = ("lenet_b64_pool1_nchw_f32", "lenet_b64_pool2_nchw_f32")
VGG_POOL_CASES = tuple(f"vgg_pool{i}_nchw_f32" for i in range(1, 6))
INCEPTION_POOL_CASES = tuple(c[0] for c in POOL_CASES
                             if c[0].startswith("inception_"))
F16_POOL_CASES = tuple(c[0] for c in POOL_CASES if c[7] == torch.float16)
# the variant of B1 each case takes, where it is not two_pass.  tiled_nhwc:
# NHWC, C a whole number of 16-byte vectors, 16-byte-aligned bases;
# tiled_nchw: rows along W (NCHW); both with 32-bit offsets and windows of
# fewer than 255 positions.  The others (C=3, the 16x16 windows, the
# 2^31-element views in either format) take two_pass.
TILED_CASES = {
    **dict.fromkeys(
        ("stem_nhwc_f32", "stem_nhwc_bf16", "stem_nhwc_bf16_relu",
         "3x3s1p1_nhwc_bf16", "3x3s2_ceil_odd_nhwc_f32",
         "3x3s2p1_c160_nhwc_bf16", "5x3s2p2x1_nhwc_f32", "1x1s2_nhwc_bf16",
         "stem_nhwc_f16", "stem_nhwc_f16_relu", "3x3s1p1_nhwc_f16",
         *(c for c in INCEPTION_POOL_CASES if c.endswith("_nhwc_bf16"))),
        "tiled_nhwc"),
    **dict.fromkeys(
        [c[0] for c in POOL_CASES
         if c[6] == "NCHW" and c[8] != "wide"
         and np.prod(np.broadcast_to(c[2], 2)) < 255],
        "tiled_nchw"),
}


def pair(v):
    return tuple(v) if isinstance(v, tuple) else (v, v)


def pool_operands(shape, k, s, p, ceil, fmt, dtype, kind, gen, device):
    """x (NCHW-indexed; for NHWC the channels_last view of an NHWC tensor),
    its pool output y, a gradient g, the pads, the kernel and the stride,
    for one case."""
    N, C, H, W = shape
    (kh, kw), (sh, sw), (ph, pw) = pair(k), pair(s), pair(p)
    dims = (N, H, W, C) if fmt == "NHWC" else shape
    if kind == "relu":
        x = torch.relu(torch.randn(dims, generator=gen, device=device))
    elif kind == "tanh":
        x = torch.tanh(torch.randn(dims, generator=gen, device=device))
    else:
        x = torch.randint(-4, 5, dims, generator=gen, device=device).float()
    x = x.to(dtype)
    if kind == "wide":  # sample n at n * 2^31 // (N - 1) of a wide buffer
        step = -(-2 ** 31 // (N - 1))
        buf = torch.empty(step * (N - 1) + x[0].numel(), dtype=dtype,
                          device=device)
        wide = buf.as_strided(dims, (step,) + x.stride()[1:])
        wide.copy_(x)
        x = wide
    if fmt == "NHWC":
        x = x.permute(0, 3, 1, 2)
    pads = nn.SpatialMaxPooling(kw, kh, sw, sh, pw, ph,
                                ceil_mode=ceil)._pads((H, W))
    with torch.no_grad():
        y = maxpool.maxpool2d(x, (kh, kw), (sh, sw), pads)
    g = torch.randn(y.shape, generator=gen, device=device).to(dtype)
    if fmt == "NHWC":
        g = g.contiguous(memory_format=torch.channels_last)
    return x, y, g, pads, (kh, kw), (sh, sw)


def kernel_pass(name):
    """B1's kernel (a variant's, a form of tiled_nchw's, or a pass of
    two_pass) that a profiled kernel name belongs to."""
    return next((p for p in ("maxpool_bwd_tiled", "maxpool_bwd_planes",
                             "maxpool_bwd_pairs", "first_match",
                             "scatter_first") if p in name), name[:40])


def variant_text(variant):
    """``maxpool.last_variant`` in words."""
    name, tile, per_block, blocks, registers = variant
    if registers:
        return (f"{name} (registers, {registers} windows a thread, blocks "
                f"{blocks})")
    what = {"tiled_nhwc": "vectors", "tiled_nchw": "planes"}.get(name)
    return (f"{name} (tile of {tile}, {what} {per_block}, blocks {blocks})"
            if what else f"{name} (blocks {blocks})")


def pool_bound(shape, y_shape, dtype):
    """(least ms, "bytes"): x, y and g read once, gi written once, at the
    card's memory rate; about one comparison per covered position, far
    below the card's rate for them."""
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = es * (2 * int(np.prod(shape)) + 2 * int(np.prod(y_shape)))
    return nbytes / HBM_BPS * 1e3, "bytes", nbytes


def pool_case_check(case, gen, device):
    """B1 against its plain version at one case of POOL_CASES, bitwise,
    in the variant TILED_CASES names."""
    name, shape, k, s, p, ceil, fmt, dtype, kind = case
    x, y, g, pads, k, s = pool_operands(shape, k, s, p, ceil, fmt, dtype,
                                        kind, gen, device)
    got = maxpool.launch(x, y, g, k, s, pads)
    variant = maxpool.last_variant
    want_variant = TILED_CASES.get(name, "two_pass")
    if variant[0] != want_variant:
        raise AssertionError(f"B1 {name}: took {variant}, want "
                             f"{want_variant}")
    want = maxpool.maxpool_bwd_reference(x, y, g, k, s, pads)
    torch.cuda.synchronize()
    # a view that is not dense gets a dense gradient (empty_like's rule)
    layout = torch.empty_like(x).stride()
    if not torch.equal(got, want) or got.stride() != layout:
        err = (got.float() - want.float()).abs().max().item()
        raise AssertionError(f"B1 {name}: not bitwise equal to its plain "
                             f"version (max abs err {err}, strides "
                             f"{got.stride()} vs {layout})")
    ties = (y == 0).float().mean().item() if kind == "relu" else None
    print(f"pool check {name}: x {tuple(x.shape)} strides {x.stride()} "
          f"{fmt} {dtype} kernel {k} stride {s} pads {pads}: "
          f"{variant_text(variant)} bitwise equal"
          + (f" (windows with an all-zero max: {ties:.3f})"
             if ties is not None else ""))
    del x, y, g, got, want
    torch.cuda.empty_cache()


def pool_kernel_phase(device, card, report):
    """B1 against its plain version at every case of POOL_CASES but VGG's,
    Inception's and the f16 ones (their phases check those), bitwise (both add the
    same terms in the same order and dtype), each in the variant that
    TILED_CASES names, then, at the ResNet-50 stem (NHWC, batch 256) in
    bf16 (the training path's type) and f32: kernel, plain and library
    times beside the bound."""
    gen = torch.Generator(device=device).manual_seed(2718)
    for case in POOL_CASES:
        if case[0] not in (VGG_POOL_CASES + INCEPTION_POOL_CASES
                           + F16_POOL_CASES):
            pool_case_check(case, gen, device)
    rows = {name: pool_row(pool_case(name), gen, device, card)
            for name in ("stem_nhwc_bf16", "stem_nhwc_f32")}
    report["pool_kernel"] = rows
    return rows["stem_nhwc_bf16"]


def pool_case(name):
    return next(c for c in POOL_CASES if c[0] == name)


def pool_row(case, gen, device, card):
    """B1 at one case of POOL_CASES on post-ReLU inputs (what every pool
    of the main paths sees): bitwise against its plain version
    on the timed inputs, in the variant TILED_CASES names, within rounding
    of the library's ``max_pool2d_with_indices_backward``, then kernel,
    plain and library times beside the bound."""
    name, shape, k, s, p, ceil, fmt, dtype = case[:8]
    x, y, g, pads, kk, ss = pool_operands(shape, k, s, p, ceil, fmt,
                                          dtype, "relu", gen, device)
    # the library's own first-match pair: indices from the forward,
    # then the backward that scatters through them
    kl, sl, pl = list(kk), list(ss), list(pair(p))
    _, ind = torch.nn.functional.max_pool2d(x, kl, sl, pl, ceil_mode=ceil,
                                            return_indices=True)
    geo = (kk, ss, pads)
    fns = (lambda: maxpool.launch(x, y, g, *geo),
           lambda: maxpool.maxpool_bwd_reference(x, y, g, *geo),
           lambda: torch.ops.aten.max_pool2d_with_indices_backward(
               g, x, kl, sl, pl, [1, 1], ceil, ind))
    # the timed inputs too: bitwise against the plain version
    got, want = fns[0](), fns[1]()
    variant = maxpool.last_variant
    want_variant = TILED_CASES.get(name, "two_pass")
    if variant[0] != want_variant:
        raise AssertionError(f"B1 {name}: took {variant}, want "
                             f"{want_variant}")
    err = (got.float() - want.float()).abs().max().item()
    if not torch.equal(got, want):
        raise AssertionError(f"B1 {name} on the timed inputs: max abs "
                             f"err {err} against its plain version")
    # the same function: the library sums a position's (at most n)
    # window gradients in f32 in another order and rounds once, B1
    # rounds to x's dtype after each add: they agree within one ulp of
    # a partial sum (at most n max|g|) for each of the n adds
    lib = fns[2]()
    n = -(-kk[0] // ss[0]) * -(-kk[1] // ss[1])
    ulp = {torch.float32: 2.0 ** -23, torch.float16: 2.0 ** -10}.get(
        dtype, 2.0 ** -7)
    torch.testing.assert_close(lib.float(), got.float(), rtol=0,
                               atol=n * n * ulp * g.abs().max().item())
    del got, want
    passes = []
    k_ev, p_ev, l_ev = (cuda_ms(f, budget_ms=100.0) for f in fns)
    k_ms = device_ms(fns[0], calls=20, split=passes)
    l_ms = device_ms(fns[2], calls=20)
    b_ms, b_by, nbytes = pool_bound(shape, y.shape, dtype)
    row = {"ms": k_ms, "plain_ms": p_ev, "library_ms": l_ms,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
           "max_abs_err": err, "event_ms": k_ev, "library_event_ms": l_ev,
           "library_call": "aten.max_pool2d_with_indices_backward "
                           "(indices from max_pool2d)",
           "passes": passes, "variant": list(variant)}
    print(f"maxpool_bwd {name} x {tuple(x.shape)} {fmt} {dtype} kernel "
          f"{kk} stride {ss} pads {pads}: {variant_text(variant)}: "
          f"max_abs_err={err} "
          f"against the plain version; device ms per call (torch.profiler) "
          f"kernel_ms={k_ms:.4f} library_ms={l_ms:.4f}; event-timed "
          f"kernel {k_ev:.4f} plain {p_ev:.4f} library {l_ev:.4f}; "
          f"bound_ms={b_ms:.4f} ({b_by}: {nbytes / 1e9:.3f} GB at "
          f"{HBM_BPS / 1e12:.2f} TB/s); by kernel: "
          + ", ".join(f"{kernel_pass(n)} {ms:.4f}" for n, ms in passes)
          + f" [{card}]")
    del x, y, g, ind, lib
    return row


# ------------------------------------------------------ ResNet-50 training
# the ImageNet recipe (examples/resnet/train_imagenet.py) on one card:
# NHWC, bf16 compute, batch 256, SGD momentum 0.9 / dampening 0 / weight
# decay 1e-4 with EpochDecayWithWarmUp (5 warm-up epochs, /10 at 30/60/80),
# max_lr scaled linearly from its batch-8192 3.2 to 0.1 at batch 256, K=4.
# The recipe's synthetic stand-in images, 1024 of them (4 steps an epoch, so
# a K=4 block is an epoch).
RESNET = {"batch": 256, "K": 4, "size": 224, "classes": 1000,
          "samples": 1024, "workers": 8, "timed_blocks": 1, "max_lr": 0.1,
          "warmup_epochs": 5, "check_batch": 8, "check_steps": 2}
# the card against the CPU (grad_reading: the losses and the first step's
# per-layer gradients; unit_reading: each conv+BN unit's per-layer
# gradients): above the sound readings, below the three planted faults
# that every run measures and requires to exceed it
RESNET_TRAIN_TOL = 1e-3


def recipe_samples(n, size, classes, seed=0):
    """The recipe's synthetic stand-in (train_imagenet.py:80-88): uint8 HWC
    images, a class-coloured patch on noise."""
    rng = np.random.default_rng(seed)
    samples = []
    for y in rng.integers(0, classes, n):
        img = rng.integers(0, 60, (size, size, 3)).astype(np.uint8)
        r, c = divmod(int(y) % 16, 4)
        q = size // 4
        img[r * q:(r + 1) * q, c * q:(c + 1) * q, int(y) % 3] += 150
        samples.append(Sample(img, np.int32(y)))
    return samples


_RESNET_DATA = {}


def resnet_data():
    """(samples, their pre-augmented Samples) of the recipe at
    RESNET["samples"] images, made once."""
    if not _RESNET_DATA:
        B, size = RESNET["batch"], RESNET["size"]
        samples = recipe_samples(RESNET["samples"], size, RESNET["classes"])
        t0 = time.monotonic()
        _RESNET_DATA["samples"] = samples
        _RESNET_DATA["augmented"] = pre_augmented(samples, B, size)
        print(f"pre-augmented {len(samples)} samples in "
              f"{time.monotonic() - t0:.1f} s (8 workers)")
    return _RESNET_DATA["samples"], _RESNET_DATA["augmented"]


def recipe_augment(size):
    """The recipe's per-sample augmentation, NHWC."""
    aug = (V.RandomAlterAspect(target_size=size) >> V.HFlip()
           >> V.ChannelNormalize((123.68, 116.78, 103.94),
                                 (58.4, 57.1, 57.4))
           >> V.ImageFrameToSample(to_chw=False))
    return lambda s: aug(V.ImageFeature(s.feature, s.label))["sample"]


def pre_augmented(samples, batch, size):
    """The recipe's pipeline run once over ``samples``: the augmented
    Samples, in order."""
    out = []
    it = (DataSet.array(samples) >> MTSampleToMiniBatch(
        batch, recipe_augment(size), workers=RESNET["workers"])).data(
            train=False)
    for b in it:
        out += [Sample(f, t) for f, t in zip(b.input, b.target)]
    return out


class RecordingSGD(optim.SGD):
    """SGD that keeps a float64 CPU copy of every step's gradients."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.grads = []

    def update(self, grads, params, state, lr, step):
        self.grads.append({k: g.detach().double().cpu()
                           for k, g in grads.items()})
        super().update(grads, params, state, lr, step)


def recipe_sgd(iters_per_epoch, cls=optim.SGD):
    warm = RESNET["warmup_epochs"] * iters_per_epoch
    max_lr = RESNET["max_lr"]
    base_lr = max_lr / warm
    return cls(learning_rate=base_lr, momentum=0.9, dampening=0.0,
               weight_decay=1e-4,
               learning_rate_schedule=optim.EpochDecayWithWarmUp(
                   warm, (max_lr - base_lr) / warm,
                   lambda e: sum(1 for d in (30, 60, 80) if e >= d)))


def resnet_train(model, dataset, device, steps, k, compute, iters_per_epoch,
                 sgd=None):
    """Train ``model`` in place through LocalOptimizer with the recipe's
    SGD (or ``sgd``); (per-step losses, per-step host clock at replay,
    optimizer, wall seconds)."""
    losses, clock = [], []

    class Recording(LocalOptimizer):
        def _log_train_iteration(self, lr):
            losses.append(self.state["loss"])
            clock.append(time.perf_counter())

    opt = (Recording(model, dataset, nn.ClassNLLCriterion(), device=device)
           .set_optim_method(sgd or recipe_sgd(iters_per_epoch))
           .set_compute_dtype(compute)
           .set_steps_per_dispatch(k)
           .set_end_when(optim.max_iteration(steps)))
    t0 = time.monotonic()
    opt.optimize()
    return losses, clock, opt, time.monotonic() - t0


def planted_b1_fault():
    """A wrapper of B1 whose first launch returns its result x127/128."""
    sound = maxpool.launch
    calls = [0]

    def launch(*args):
        calls[0] += 1
        gi = sound(*args)
        return gi * (127 / 128) if calls[0] == 1 else gi
    return launch


def zero_init_residual(model):
    """``model`` with the last BatchNorm's gamma of every residual block's
    main path at 0 (the large-batch ImageNet recipe's init, Goyal et al.
    2017): each block starts as its shortcut."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.ConcatTable):
                main = m[0]
                main[len(main) - 1][1].weight.zero_()
    return model


def unit_grads(unit, a, seed, device, fault=None):
    """One conv+BatchNorm unit's gradients (parameters, and ``input``) on
    ``device`` for the input ``a`` and a seeded N(0, 1) gradient at its
    output; ``fault`` edits the unit's copy first."""
    u = copy.deepcopy(unit).to(device).train()
    if fault is not None:
        fault(u)
    params = dict(u.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    a = a.to(device, copy=True).requires_grad_(True)
    out = u(a)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed))
    (out * g.to(device)).sum().backward()
    grads = {k: p.grad.double().cpu() for k, p in params.items()}
    grads["input.x"] = a.grad.double().cpu()
    return grads


def layer_shares(got, ref, prefix=""):
    """Per layer (parameters grouped by module), the largest difference of
    ``got`` from ``ref`` as a share of the layer's largest value in ``ref``
    (a layer that is all zero in ``ref`` must be all zero in ``got``):
    [(share, layer)]."""
    layers = {}
    for k in ref:
        layers.setdefault(k.rsplit(".", 1)[0], []).append(k)
    rows = []
    for layer, keys in layers.items():
        scale = max(ref[k].abs().max().item() for k in keys)
        diff = max((got[k] - ref[k]).abs().max().item() for k in keys)
        rows.append((diff / scale if scale > 0 else
                     (0.0 if diff == 0 else float("inf")), prefix + layer))
    return rows


def unit_reading(model, x, device):
    """Every conv+BatchNorm unit of ``model`` (53 in ResNet-50: the stem,
    3 a block, 4 shortcuts; f32, training mode) on the card against the
    CPU, each from its input in the CPU's forward of ``x`` and a seeded
    gradient at its output: (largest share, its four largest (share,
    layer), the planted fault's reading).  No ReLU lies inside a unit, so
    rounding cannot flip a mask between the devices.  The fault is block
    8's 3x3 conv weight x127/128 on the card (the BatchNorm after it
    cancels the scale in the forward; the weight's gradient grows by
    128/127)."""
    net = copy.deepcopy(model).train()
    units = {name: m for name, m in net.named_modules()
             if isinstance(m, nn.Sequential) and len(m) == 2
             and isinstance(m[0], nn.SpatialConvolution)
             and isinstance(m[1], nn.SpatialBatchNormalization)}
    inputs = {}
    for name, m in units.items():
        m.register_forward_pre_hook(
            lambda mod, args, name=name: inputs.__setitem__(name, args[0]))
    with torch.no_grad():
        net(x)
    rows, fault = [], None
    for seed, (name, unit) in enumerate(units.items()):
        unit = copy.deepcopy(unit)
        unit._forward_pre_hooks.clear()
        want = unit_grads(unit, inputs[name], seed, "cpu")
        rows += layer_shares(unit_grads(unit, inputs[name], seed, device),
                             want, f"{name}.")
        if name == "8.0.0.2":
            fault = max(layer_shares(unit_grads(
                unit, inputs[name], seed, device,
                lambda u: u[0].weight.data.mul_(127 / 128)), want,
                f"{name}."))
    rows.sort(reverse=True)
    return rows[0][0], rows[:4], fault, len(units)


def resnet_check_phase(seed, device, card, report):
    """ResNet-50 (224x224, 1000 classes, NHWC, f32) on the card against the
    CPU, in two readings, each against RESNET_TRAIN_TOL with planted faults
    that must read above it:

    - the path: RESNET["check_steps"] steps of batch 8 in one block through
      LocalOptimizer, from the same seeded weights and the same augmented
      batches, residual gammas at 0 (:func:`grad_reading`); faults: the
      stem conv's weight x127/128 and B1's first result x127/128;
    - every conv+BatchNorm unit at the model's own init (gammas 1), each
      from its input in the CPU's forward of the first batch
      (:func:`unit_reading`); fault: block 8's 3x3 conv weight x127/128.

    Why two: whole-model f32 gradients of this model at batch 8 are
    ill-conditioned whenever gradient reaches the blocks' inner layers:
    the card and the CPU then differ by percents of a layer's largest
    gradient, as much as the CPU differs from itself when a batch's samples
    are reversed (``--phases resnet-conditioning`` measures both).  At
    gamma 0 the path is well conditioned, but the inner layers get no
    gradient at the first step and a fault there reads nothing; the unit
    reading holds them, one conv and its BatchNorm at a time.  (Whole
    blocks are ill-conditioned too: a ReLU whose input lies within
    rounding of 0 on one device and not the other sends a different
    gradient through that position.)"""
    B, steps = RESNET["check_batch"], RESNET["check_steps"]
    data = pre_augmented(recipe_samples(B * steps, RESNET["size"],
                                        RESNET["classes"], seed),
                         B, RESNET["size"])
    plain = resnet50(RESNET["classes"], format="NHWC").initialize(seed)
    init = zero_init_residual(copy.deepcopy(plain))

    def run(dev, model=None):
        sgd = recipe_sgd(steps, RecordingSGD)
        losses = resnet_train(model or copy.deepcopy(init),
                              DataSet.array(data) >> SampleToMiniBatch(B),
                              dev, steps, steps, None, steps, sgd)[0]
        return losses, sgd.grads

    t0 = time.monotonic()
    want = run("cpu")
    cpu_s = time.monotonic() - t0
    maxpool.launches = 0
    got = run(device)
    if maxpool.launches != steps:
        raise AssertionError(f"B1 launched {maxpool.launches} times in "
                             f"{steps} steps")
    sound, worst, later = grad_reading(got, want)
    faults, fault_worst = {}, {}
    m = copy.deepcopy(init)
    with torch.no_grad():
        m[0][0].weight.mul_(127 / 128)  # the stem conv
    faults["stem_weight_127_128"], fault_worst["stem_weight_127_128"], _ = \
        grad_reading(run(device, m), want)
    sound_launch = maxpool.launch
    maxpool.launch = planted_b1_fault()
    try:
        faults["b1_one_step_127_128"], fault_worst["b1_one_step_127_128"], \
            _ = grad_reading(run(device), want)
    finally:
        maxpool.launch = sound_launch

    x = torch.from_numpy(np.stack([s.feature for s in data[:B]]))
    units, units_worst, unit_fault, n_units = unit_reading(plain, x, device)
    faults["block8_conv2_weight_127_128"] = unit_fault[0]
    fault_worst["block8_conv2_weight_127_128"] = [unit_fault]
    print(f"resnet50 train-vs-cpu largest shares (share, layer): path "
          f"{worst}, later steps (not gated) {later}; units "
          f"{units_worst}; "
          + "; ".join(f"{k} {v}" for k, v in fault_worst.items()))
    print(f"resnet50 train-vs-cpu check, NHWC f32: path ({steps} steps of "
          f"batch {B} in one block, residual gammas at 0) {sound:.3e}, "
          f"conv+BN units ({n_units}, gammas 1, batch {B}) {units:.3e}, "
          f"planted faults "
          + ", ".join(f"{k} {v:.3e}" for k, v in faults.items())
          + f" (tol {RESNET_TRAIN_TOL}); cpu losses "
          + ", ".join(f"{v:.6f}" for v in want[0]) + "; card losses "
          + ", ".join(f"{v:.6f}" for v in got[0])
          + f"; the CPU's block took {cpu_s:.1f} s [{card}]")
    report["resnet_check"] = {"sound": sound, "largest": worst,
                              "later_steps": later, "units": units,
                              "units_largest": units_worst,
                              "planted_faults": faults,
                              "planted_largest": fault_worst,
                              "tol": RESNET_TRAIN_TOL,
                              "cpu_losses": want[0], "card_losses": got[0]}
    for name, err in (("training", sound), ("conv+BN units", units)):
        if not err <= RESNET_TRAIN_TOL:
            raise AssertionError(f"ResNet-50 on the card ({name}) is "
                                 f"{err:.3e} from the CPU, over the limit "
                                 f"{RESNET_TRAIN_TOL}")
    for fault, err in faults.items():
        if not err > RESNET_TRAIN_TOL:
            raise AssertionError(
                f"planted fault {fault} reads {err:.3e}, inside the ResNet-50 "
                f"training tolerance {RESNET_TRAIN_TOL}: the check is blind")


def resnet_conditioning_phase(seed, device, card, report):
    """Why the check phase holds the conv+BN units one at a time (not run by
    default): the path reading (:func:`grad_reading`) of its K=2 block at
    residual gammas 0, 0.001, 0.1 and 1, card against CPU, beside the
    CPU's own reading of the same steps with each batch's samples in
    reverse order (the same sums in another order)."""
    B, steps = RESNET["check_batch"], RESNET["check_steps"]
    data = pre_augmented(recipe_samples(B * steps, RESNET["size"],
                                        RESNET["classes"], seed),
                         B, RESNET["size"])
    rev = [s for i in range(0, len(data), B) for s in data[i:i + B][::-1]]
    plain = resnet50(RESNET["classes"], format="NHWC").initialize(seed)
    out = {}
    for gamma in (0.0, 0.001, 0.1, 1.0):
        init = copy.deepcopy(plain)
        with torch.no_grad():
            for m in init.modules():
                if isinstance(m, nn.ConcatTable):
                    m[0][len(m[0]) - 1][1].weight.fill_(gamma)

        def run(dev, d):
            sgd = recipe_sgd(steps, RecordingSGD)
            losses = resnet_train(copy.deepcopy(init), DataSet.array(d)
                                  >> SampleToMiniBatch(B), dev, steps, steps,
                                  None, steps, sgd)[0]
            return losses, sgd.grads
        want = run("cpu", data)
        card_r = grad_reading(run(device, data), want)
        cpu_r = grad_reading(run("cpu", rev), want)
        out[gamma] = {"card": card_r[:2], "cpu_reversed": cpu_r[:2]}
        print(f"resnet50 conditioning, residual gammas {gamma}: card vs cpu "
              f"{card_r[0]:.3e} {card_r[1][:2]}; cpu on reversed batches vs "
              f"cpu {cpu_r[0]:.3e} {cpu_r[1][:2]} [{card}]")
    report["resnet_conditioning"] = out


def grad_reading(run, want):
    """How far a training run ``(losses, per-step gradients)`` is from the
    CPU's: the larger of the relative loss difference over the steps and,
    per layer, the largest difference of the first step's gradients as a
    share of the layer's largest gradient on the CPU (a layer whose CPU
    gradient is all zero must be all zero on the card too).  Returns the
    reading, its four largest (share, layer) and, not gated, the largest
    share of each later step.

    Per layer, not per array: a BatchNorm bias's gradient sums the gradient
    at the layer's output over N*H*W positions, a sum that nearly cancels,
    and is held to the scale of the weight's gradient, which sums the same
    terms times x_hat.  First step only: later steps start from weights
    that already differ in their last bits, and their gradients depend on
    them ill-conditionedly, so those steps are held by their losses."""
    (losses, grads), (want_losses, want_grads) = run, want
    rows = [(abs(a - b) / abs(b), f"step {j} loss")
            for j, (a, b) in enumerate(zip(losses, want_losses))]
    rows += layer_shares(grads[0], want_grads[0])
    later = [max(layer_shares(g, w))
             for g, w in zip(grads[1:], want_grads[1:])]
    rows.sort(reverse=True)
    return rows[0][0], rows[:4], later


def resnet_profile_step(init, batch, device, card):
    """One bf16 step of the recipe (forward, backward, SGD update) under
    torch.profiler after a warm-up step: wall ms, device busy ms, idle share,
    kernel launches and the top device operations."""
    net = copy.deepcopy(init).to(device).train()
    params = dict(net.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    sgd = recipe_sgd(RESNET["samples"] // RESNET["batch"])
    ostate = sgd.init_state(params)
    loss_fn = mixed_precision_loss_fn(net, nn.ClassNLLCriterion(),
                                      torch.bfloat16)
    x = torch.from_numpy(np.stack([s.feature for s in batch])).to(device)
    y = torch.from_numpy(np.stack([s.label for s in batch])).to(device)

    def step():
        for p in params.values():
            p.grad = None
        loss_fn(params, x, y).backward()
        sgd.update({k: p.grad for k, p in params.items()}, params, ostate,
                   0.01, 0)

    return profile_step(step, f"resnet50 train step (bf16, batch "
                        f"{len(batch)})", card, 8)


def resnet_timed_phase(seed, device, card, report):
    """The recipe on the card, timed twice: through its own pipeline
    (MTSampleToMiniBatch, 8 workers) and over batches augmented beforehand.
    Each run: a warm-up block then RESNET["timed_blocks"] K=4 blocks;
    images/s and ms per step from the host clock at which each block's
    losses came back; per-block loss (finite, falling); peak memory; B1's
    launches (one a step).  Then one profiled step."""
    B, K, size = RESNET["batch"], RESNET["K"], RESNET["size"]
    steps = K * (1 + RESNET["timed_blocks"])
    per_epoch = RESNET["samples"] // B
    samples, augmented = resnet_data()
    init = resnet50(RESNET["classes"], format="NHWC").initialize(seed)
    datasets = {
        "pipeline": lambda: DataSet.array(samples) >> MTSampleToMiniBatch(
            B, recipe_augment(size), workers=RESNET["workers"]),
        "pre_augmented": lambda: DataSet.array(augmented)
        >> SampleToMiniBatch(B)}
    out, launches = {}, {}
    sound_launch = maxpool.launch
    for name, make in datasets.items():
        t0 = time.monotonic()
        model = copy.deepcopy(init)
        torch.cuda.reset_peak_memory_stats()
        maxpool.reset_counts()
        dtypes = []  # of every B1 launch: the stem's activation is bf16

        def launch(x, *a):
            dtypes.append(x.dtype)
            return sound_launch(x, *a)
        maxpool.launch = launch
        try:
            losses, clock, opt, wall = resnet_train(
                model, make(), device, steps, K, torch.bfloat16, per_epoch)
        finally:
            maxpool.launch = sound_launch
        launches[name] = maxpool.launches
        peak = torch.cuda.max_memory_allocated()
        if launches[name] != steps or opt.state["neval"] != steps:
            raise AssertionError(f"{name}: B1 launched {launches[name]} "
                                 f"times in {opt.state['neval']} steps")
        if set(dtypes) != {torch.bfloat16}:
            raise AssertionError(f"{name}: B1 ran on {set(dtypes)}, not on "
                                 f"the bf16 compute dtype")
        if maxpool.variant_launches["tiled_nhwc"] != steps:
            raise AssertionError(f"{name}: B1 variants "
                                 f"{maxpool.variant_launches}, want "
                                 f"{steps} tiled_nhwc")
        blocks = [float(np.mean(losses[i:i + K]))
                  for i in range(0, steps, K)]
        if not (np.all(np.isfinite(losses)) and blocks[-1] < blocks[0]):
            raise AssertionError(f"{name}: the loss is not finite and "
                                 f"falling: {blocks}")
        # block b's losses come back after block b+1 is enqueued: the
        # clock at the last step of each block marks that block's end
        ends = [clock[i + K - 1] for i in range(0, steps, K)]
        step_s = (ends[-1] - ends[0]) / (steps - K)
        out[name] = {"ms_per_step": step_s * 1e3,
                     "images_per_s": B / step_s, "block_losses": blocks,
                     "losses": losses, "max_memory_allocated": peak,
                     "launches": launches[name], "wall_s": wall,
                     "epoch": opt.state["epoch"]}
        print(f"train resnet50 {name} NHWC bf16 batch {B} K={K}: {steps} "
              f"steps, the {RESNET['timed_blocks']} blocks after the first: "
              f"ms_per_step={step_s * 1e3:.2f} images_per_s={B / step_s:.1f} "
              f"max_memory_allocated={peak} block losses "
              + ", ".join(f"{v:.4f}" for v in blocks)
              + f"; B1 launches {launches[name]} for {steps} steps, all "
              f"bf16 tiled_nhwc; "
              f"final: epoch={opt.state['epoch']} "
              f"loss={opt.state['loss']:.4f}; run {time.monotonic() - t0:.1f} "
              f"s [{card}]")
        del model, opt
        torch.cuda.empty_cache()
    out["profile"] = resnet_profile_step(init, augmented[:B], device, card)
    report["resnet_train"] = out
    return launches["pipeline"]


# ------------------------------------------------------- Wide&Deep, B3
BAG_KERNEL = {"route": "cuda", "source": "bigdl_tpu_torch/csrc/embed_bag.cu",
              "replaces": "bigdl_tpu/ops/pallas_embed.py:151"}
# the census Wide&Deep of bench.py's _wide_deep_measure: wide table
# 100,000 x 1, deep fields 10000/1000/100/100/50 at embed 16, 13 dense
# features, MLP (100, 50), batch 8192 with 8 wide ids a sample (nnz 65,536),
# f32; K=8 (bench.py PRODUCTION_K["wide_deep"]); Adam at lr 0.01, the
# recipe's --sparse-coo optimizer (examples/recommender/train_wide_deep.py)
WD = {"wide": 100_000, "fields": (10_000, 1_000, 100, 100, 50), "embed": 16,
      "dense": 13, "hidden": (100, 50), "batch": 8192, "nnz_per": 8, "K": 8,
      "lr": 0.01, "timed_blocks": 3}
# (name, N, V, D, nnz, table dtype, values dtype, layout): the census wide
# path, D 16, 128 and a ragged 129, unsorted rows with duplicates, empty
# rows and the padding tail, bf16 table and values, a single row, a table
# of 2^31 elements or more (64-bit offsets; its table gradient groups 2^24+1
# keys, more than one window of the fine pass a bucket), and every entry on
# one key in both roles.  "census": 8 ids a sample in row order; "unsorted":
# rows drawn at random from 90% of the rows, then an nnz/16 padding tail of
# (0, 0, 0.0); "one_key": every row 0, every col one value.
BAG_CASES = [
    ("census", 8192, 100_000, 1, 65_536, torch.float32, torch.float32,
     "census"),
    ("d16", 2048, 50_000, 16, 16_384, torch.float32, torch.float32,
     "unsorted"),
    ("d128", 1024, 20_000, 128, 8192, torch.float32, torch.float32,
     "unsorted"),
    ("d129_ragged", 1000, 5000, 129, 8000, torch.float32, torch.float32,
     "unsorted"),
    ("unsorted_pad_d1", 8192, 100_000, 1, 65_536, torch.float32,
     torch.float32, "unsorted"),
    ("bf16", 4096, 30_000, 16, 32_768, torch.bfloat16, torch.bfloat16,
     "unsorted"),
    ("bf16_table_f32_values", 4096, 30_000, 16, 32_768, torch.bfloat16,
     torch.float32, "unsorted"),
    ("single_row", 1, 1000, 8, 64, torch.float32, torch.float32, "unsorted"),
    ("offsets_64bit", 64, 2 ** 24 + 1, 128, 4096, torch.bfloat16,
     torch.bfloat16, "unsorted"),
    ("one_key", 8192, 100_000, 1, 65_536, torch.float32, torch.float32,
     "one_key"),
]
# B3's grouping passes alone (not the bag walk: these keys would index the
# table or g out of range) against row_index (check_grouping): (name, nnz,
# n_keys, low, high) with keys uniform in [low, high), so some lie below 0
# and at or above n_keys; then the stream's first entries set to int32's
# extremes.
# The census shapes of both roles, keys all below 0, all above, an empty
# stream, a stream of chunks of 23 tiles (above 1024 x 128 entries), and
# keys over all of int32 into 2^27 keys (1024 windows of the fine pass a
# bucket).
GROUP_EDGE_CASES = [
    ("census_rows_out_of_range", 65_536, 8192, -3000, 8192 + 3000),
    ("census_cols_out_of_range", 65_536, 100_000, -5000, 105_000),
    ("all_below_0", 4096, 1000, -2 ** 31, 0),
    ("all_at_or_above_n_keys", 4096, 1000, 1000, 2 ** 31),
    ("empty_stream", 0, 1000, 0, 1000),
    ("multi_tile_chunks", 3_000_000, 100_000, -10, 100_010),
    ("int32_range", 65_536, 2 ** 27, -2 ** 31, 2 ** 31),
]
# the kernels of one B3 call, each from csrc/embed_bag.cu: the grouping
# passes 1-3, then the bag walk
BAG_PASSES = ("bag_hist", "bag_coarse", "bag_fine", "bag_walk")
# the card's K=8 block against the CPU (wd_step_reading): above the sound
# reading and below the three planted faults that every run measures and
# requires to exceed it
WD_TRAIN_TOL = 3e-5


def bag_operands(case, gen, device):
    """rows, cols, values, table and an output gradient g for one case."""
    _, N, V, D, nnz, tdtype, vdtype, layout = case
    if layout == "census":
        rows = torch.arange(N, device=device, dtype=torch.int32) \
            .repeat_interleave(nnz // N)
        cols = torch.randint(0, V, (nnz,), generator=gen, device=device,
                             dtype=torch.int32)
        vals = torch.ones(nnz, device=device)
    elif layout == "one_key":
        rows = torch.zeros(nnz, device=device, dtype=torch.int32)
        cols = torch.randint(0, V, (1,), generator=gen, device=device,
                             dtype=torch.int32).expand(nnz).contiguous()
        vals = torch.randn(nnz, generator=gen, device=device)
    else:
        pad = nnz // 16
        live = torch.nonzero(torch.rand(N, generator=gen, device=device)
                             > 0.1).flatten() if N > 1 else \
            torch.zeros(1, dtype=torch.long, device=device)
        pick = torch.randint(0, live.numel(), (nnz - pad,), generator=gen,
                             device=device)
        z = torch.zeros(pad, dtype=torch.int32, device=device)
        rows = torch.cat([live[pick].to(torch.int32), z])
        lo = V - 4096 if V > 2 ** 24 else 0  # reach the table's far end
        cols = torch.cat([torch.randint(lo, V, (nnz - pad,), generator=gen,
                                        device=device, dtype=torch.int32), z])
        vals = torch.cat([torch.randn(nnz - pad, generator=gen,
                                      device=device),
                          torch.zeros(pad, device=device)])
    table = torch.empty((V, D), dtype=tdtype, device=device)
    table.normal_(generator=gen)
    g = torch.randn((N, D), generator=gen, device=device)
    return rows, cols, vals.to(vdtype), table, g


def bag_bound(rows, cols, table, out_rows, out_dtype):
    """(least ms, "bytes" | "operations", bytes): rows, cols and values
    read once, the table rows this stream names read once, the output
    written once, at the card's memory rate; one FMA (2 operations) per
    entry and column at the f32 rate."""
    D, es = table.shape[1], table.element_size()
    n_rows_read = int(torch.unique(cols).numel())
    out_es = torch.tensor([], dtype=out_dtype).element_size()
    nbytes = 12 * rows.numel() + n_rows_read * D * es + out_rows * D * out_es
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = 2.0 * rows.numel() * D / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations", nbytes


def library_bag(rows, cols, vals, table, n_rows):
    """One PyTorch call for the same bag sum, over the row-sorted stream:
    ``F.embedding_bag(..., mode="sum", per_sample_weights=...)`` (a
    yardstick; the port never calls it)."""
    perm, offsets = embed_bag.row_index(rows, n_rows)
    idx, w = cols[perm].long(), vals[perm].to(table.dtype)
    starts = offsets[:-1].contiguous()
    return lambda: torch.nn.functional.embedding_bag(
        idx, table, starts, mode="sum", per_sample_weights=w)


def library_route(rows, cols, vals, table, n_rows):
    """The whole call on library calls from the unsorted stream: a stable
    ``torch.sort``, ``searchsorted``, the gathers and ``F.embedding_bag``
    (a yardstick; the port never calls it)."""
    def run():
        perm, offsets = embed_bag.row_index(rows, n_rows)
        return torch.nn.functional.embedding_bag(
            cols[perm].long(), table, offsets[:-1], mode="sum",
            per_sample_weights=vals[perm].to(table.dtype))
    return run


def check_grouping(keys, n_keys, what):
    """B3's grouping passes against row_index, bitwise, in the plan's
    index dtype: offsets in full, perm over [offsets[0], offsets[n_keys])
    (what the bag walk reads); before it the entries with keys below 0 and
    after it those at or above n_keys, each in nnz order (row_index orders
    these by key)."""
    perm, offsets = embed_bag.group_index(keys, n_keys)
    want_perm, want_offsets = embed_bag.row_index(keys, n_keys)
    dtype = embed_bag.group_plan(keys.numel(), n_keys).index_dtype
    torch.cuda.synchronize()
    if perm.dtype != dtype or offsets.dtype != dtype:
        raise AssertionError(f"B3 grouping {what}: {perm.dtype} / "
                             f"{offsets.dtype}, want {dtype}")
    if not torch.equal(offsets.long(), want_offsets):
        bad = torch.nonzero(offsets.long() != want_offsets)[:5].flatten()
        raise AssertionError(f"B3 grouping {what}: offsets differ from "
                             f"row_index's first at {bad.tolist()}")
    lo, hi = int(want_offsets[0]), int(want_offsets[-1])
    k = keys.long()
    for part, got, want in (
            ("below 0", perm[:lo], torch.nonzero(k < 0).flatten()),
            ("in range", perm[lo:hi], want_perm[lo:hi]),
            ("at or above n_keys", perm[hi:],
             torch.nonzero(k >= n_keys).flatten())):
        if not torch.equal(got.long(), want):
            raise AssertionError(f"B3 grouping {what}: perm's entries {part} "
                                 f"differ from the stream's")


def grouping_split(keys, n_keys, card):
    """Device ms of B3's grouping passes alone on ``keys`` into ``n_keys``,
    split by pass: at 2^24+1 keys each of the fine pass's 129 buckets walks
    its 2^17 keys in 1024-key windows and writes that many offsets."""
    split = []
    ms = device_ms(lambda: embed_bag.group_index(keys, n_keys), calls=10,
                   split=split)
    by_pass = {p: sum(t for name, t in split if p in name)
               for p in BAG_PASSES[:3]}
    plan = embed_bag.group_plan(keys.numel(), n_keys)
    print(f"bag grouping alone nnz={keys.numel()} n_keys={n_keys} "
          f"({plan.buckets} buckets, shift {plan.shift}: "
          f"{-(-(1 << plan.shift) // 1024)} windows a bucket): device ms "
          f"{ms:.5f} (" + ", ".join(f"{p} {t:.5f}" for p, t in by_pass.items())
          + f") [{card}]")
    return {"n_keys": n_keys, "nnz": keys.numel(), "ms": ms,
            "split": by_pass}


def group_edge_keys(nnz, low, high, gen, device):
    keys = torch.randint(low, high, (nnz,), generator=gen, device=device,
                         dtype=torch.int64)
    keys[:4] = torch.tensor([-2 ** 31, 2 ** 31 - 1, -1, 0])[:nnz]
    return keys.clamp(low, high - 1).to(torch.int32)


def bag_kernel_phase(device, card, report):
    """B3 against its plain version, bitwise, at every case of BAG_CASES,
    forward and the swapped-role weight gradient, with its grouping passes'
    (perm, offsets) bitwise against row_index in both roles; the grouping
    alone at GROUP_EDGE_CASES, and timed by pass at the widest key range
    (offsets_64bit's 2^24+1 keys); then at the census shape, for the forward
    and for the weight gradient: one call with host syncs made errors, the
    call's device time split by kernel (each one of BAG_PASSES), an
    event-timed loop of the whole wrapper, the plain version, the library
    route (sort, searchsorted, ``F.embedding_bag``) and ``F.embedding_bag``
    alone on the pre-sorted stream, beside the bound."""
    gen = torch.Generator(device=device).manual_seed(3141)
    err, wide_keys = 0.0, None
    for case in BAG_CASES:
        name, N, V = case[:3]
        rows, cols, vals, table, g = bag_operands(case, gen, device)
        check_grouping(rows, N, f"{name} forward")
        check_grouping(cols, V, f"{name} table gradient")
        got = embed_bag.launch(rows, cols, vals, table, N)
        want = embed_bag.embedding_bag_coo_reference(rows, cols, vals, table,
                                                     N)
        got_t = embed_bag.launch(cols, rows, vals, g, V)
        want_t = embed_bag.embedding_bag_coo_reference(cols, rows, vals, g, V)
        torch.cuda.synchronize()
        same = [torch.equal(got, want), torch.equal(got_t, want_t)]
        # the difference only where they differ: the 64-bit case's table
        # gradient alone is 8.6 GB
        errs = [0.0 if eq else (a.float() - b.float()).abs().max().item()
                for eq, (a, b) in zip(same, ((got, want), (got_t, want_t)))]
        err = max([err] + errs)
        if not all(same):
            raise AssertionError(f"B3 {name}: not bitwise equal to its "
                                 f"plain version (max abs err forward "
                                 f"{errs[0]}, table gradient {errs[1]})")
        if got.dtype != torch.result_type(table, vals):
            raise AssertionError(f"B3 {name}: output dtype {got.dtype}")
        empty = N - int(torch.unique(rows).numel())
        print(f"bag check {name}: N={N} V={V} D={table.shape[1]} nnz="
              f"{rows.numel()} table {table.dtype} values {vals.dtype}, "
              f"{empty} empty rows: grouping (perm, offsets) of both roles "
              f"equal to row_index's, forward and table gradient bitwise "
              f"equal")
        if V > 2 ** 24:  # the widest key range: the fine pass's windows
            wide_keys = grouping_split(cols, V, card)
        del rows, cols, vals, table, g, got, want, got_t, want_t
        torch.cuda.empty_cache()
    for name, nnz, n_keys, low, high in GROUP_EDGE_CASES:
        keys = group_edge_keys(nnz, low, high, gen, device)
        check_grouping(keys, n_keys, name)
        plan = embed_bag.group_plan(nnz, n_keys)
        outside = int(((keys < 0) | (keys >= n_keys)).sum())
        print(f"bag grouping check {name}: nnz={nnz} n_keys={n_keys}, "
              f"{outside} keys outside [0, n_keys): perm and offsets equal "
              f"to row_index's ({plan.buckets} buckets, shift "
              f"{plan.shift}, chunk {plan.chunk})")
        del keys

    rows, cols, vals, table, g = bag_operands(BAG_CASES[0], gen, device)
    N, V = BAG_CASES[0][1:3]
    out = {}
    for role, args, n_out in (("forward", (rows, cols, vals, table, N), N),
                              ("table_grad", (cols, rows, vals, g, V), V)):
        r, c, v, t, n = args
        fns = (lambda: embed_bag.launch(*args),
               lambda: embed_bag.embedding_bag_coo_reference(*args),
               library_bag(r, c, v, t, n), library_route(r, c, v, t, n))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # a host sync would raise
        try:
            got = fns[0]()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        want, lib, route = (f() for f in fns[1:])
        e = (got - want).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"B3 {role} on the timed inputs: max abs "
                                 f"err {e} against its plain version")
        # the library sums each bag in its own order: within rounding
        for y in (lib, route):
            torch.testing.assert_close(y.float(), got.float(), rtol=1e-5,
                                       atol=1e-5 * got.abs().max().item())
        err = max(err, e)
        split = []
        k_ms = device_ms(fns[0], calls=50, split=split)
        by_pass = {p: sum(ms for name, ms in split if p in name)
                   for p in BAG_PASSES}
        foreign = [name for name, _ in split
                   if not any(p in name for p in BAG_PASSES)]
        if foreign or not all(by_pass.values()):
            raise AssertionError(f"B3 {role}: a call launched {foreign} "
                                 f"beside csrc/embed_bag.cu's kernels, or "
                                 f"not each of {BAG_PASSES}: {split}")
        l_ms, route_ms = (device_ms(f, calls=50) for f in fns[2:])
        k_ev, p_ev, l_ev, route_ev = (cuda_ms(f) for f in fns)
        b_ms, b_by, nbytes = bag_bound(r, c, t, n_out, got.dtype)
        out[role] = {"ms": k_ms, "split": by_pass,
                     "group_ms": k_ms - by_pass["bag_walk"],
                     "event_ms": k_ev, "plain_ms": p_ev, "library_ms": l_ms,
                     "library_event_ms": l_ev, "library_route_ms": route_ms,
                     "library_route_event_ms": route_ev, "bound_ms": b_ms,
                     "bound_by": b_by, "bytes": nbytes, "max_abs_err": e,
                     "plan": embed_bag.group_plan(r.numel(), n)._asdict()}
        print(f"embed_bag {role} N={n_out} nnz={r.numel()} D={t.shape[1]}: "
              f"device ms per call, whole call kernel_ms={k_ms:.5f} ("
              + ", ".join(f"{p} {ms:.5f}" for p, ms in by_pass.items())
              + f"; only csrc/embed_bag.cu's kernels, no host sync) "
              f"library_ms={l_ms:.5f} [F.embedding_bag, pre-sorted] "
              f"library_route_ms={route_ms:.5f} [sort + searchsorted + "
              f"F.embedding_bag]; event-timed wrapper {k_ev:.5f} plain "
              f"{p_ev:.5f} library {l_ev:.5f} route {route_ev:.5f}; "
              f"bound_ms={b_ms:.6f} ({b_by}: {nbytes} B at "
              f"{HBM_BPS / 1e12:.2f} TB/s) [{card}]")
        del got, want, lib, route
    out["wide_keys_grouping"] = wide_keys
    report["bag_kernel"] = out
    row = dict(out["forward"])
    row["max_abs_err"] = err
    return row


def wd_model(seed):
    return WideAndDeep(WD["wide"], list(WD["fields"]), WD["dense"],
                       WD["embed"], WD["hidden"]).initialize(seed)


def wd_data(n, seed):
    """n census-shaped records as numpy columns: 8 wide ids a record with
    value 1, one id per deep field, 13 N(0, 1) dense features, and a
    label from a planted teacher: the sign of the sum of an N(0, 1) weight
    per wide id and per field-0 id, so that the loss can fall."""
    rng = np.random.default_rng(seed)
    k = WD["nnz_per"]
    wide = rng.integers(0, WD["wide"], (n, k)).astype(np.int32)
    deep = np.stack([rng.integers(0, c, n) for c in WD["fields"]],
                    axis=1).astype(np.int32)
    dense = rng.normal(0, 1, (n, WD["dense"])).astype(np.float32)
    w_wide = rng.normal(0, 1, WD["wide"])
    w_f0 = rng.normal(0, 1, WD["fields"][0])
    logit = w_wide[wide].sum(1) / np.sqrt(k) + w_f0[deep[:, 0]]
    return wide, deep, dense, (logit > 0).astype(np.float32)


def wd_samples(cols):
    """The records as the recipe's SparseSamples."""
    wide, deep, dense, y = cols
    ones = np.ones(WD["nnz_per"], np.float32)
    return [SparseSample(wide[i], ones, WD["wide"], dense=[deep[i], dense[i]],
                         label=y[i]) for i in range(len(y))]


def wd_batches(cols):
    """The records as SparseMiniBatches of WD["batch"], built from the
    columns (the same arrays batch_sparse_samples gives)."""
    wide, deep, dense, y = cols
    B, k = WD["batch"], WD["nnz_per"]
    row = np.repeat(np.arange(B, dtype=np.int32), k)
    ones = torch.ones(B * k)
    out = []
    for s in range(0, len(y) - B + 1, B):
        coo = nn.COOBatch(torch.from_numpy(row),
                          torch.from_numpy(wide[s:s + B].reshape(-1)), ones,
                          (B, WD["wide"]))
        out.append(SparseMiniBatch((coo, deep[s:s + B], dense[s:s + B]),
                                   y[s:s + B]))
    return out


class SparseToMiniBatch(Transformer):
    """The recipe's feed: SparseSamples in batches of WD["batch"] through
    batch_sparse_samples at the census nnz."""

    def __call__(self, it):
        buf = []
        for s in it:
            buf.append(s)
            if len(buf) == WD["batch"]:
                yield batch_sparse_samples(buf, [WD["batch"] * WD["nnz_per"]])
                buf = []


class Prebuilt(Transformer):
    """Batches built beforehand, in turn, one for every ``per`` (default
    WD["batch"]) records the dataset yields (the records themselves are not
    read)."""

    def __init__(self, batches, per=None):
        self.batches = batches
        self.per = per or WD["batch"]

    def __call__(self, it):
        for i in itertools.count():
            for _ in range(self.per):
                next(it)
            yield self.batches[i % len(self.batches)]


class SqueezedBCE:
    """BCE on the (N, 1) score's column (bench.py's _SqueezeBCE)."""

    def __init__(self):
        self.bce = nn.BCECriterion()

    def apply(self, out, y):
        return self.bce.apply(out[:, 0], y)


def wd_train(model, dataset, device, steps, method=None, compute_dtype=None):
    """Train ``model`` in place through LocalOptimizer with the recipe's
    Adam (or ``method``) in K=8 blocks, computing in ``compute_dtype``
    (default f32): (per-step losses, per-step host clock at replay,
    optimizer, wall seconds)."""
    losses, clock = [], []

    class Recording(LocalOptimizer):
        def _log_train_iteration(self, lr):
            losses.append(self.state["loss"])
            clock.append(time.perf_counter())

    opt = (Recording(model, dataset, SqueezedBCE(), device=device)
           .set_optim_method(method or optim.Adam(learning_rate=WD["lr"]))
           .set_compute_dtype(compute_dtype)
           .set_steps_per_dispatch(WD["K"])
           .set_end_when(optim.max_iteration(steps)))
    t0 = time.monotonic()
    opt.optimize()
    return losses, clock, opt, time.monotonic() - t0


def planted_bag_fault(role, step):
    """A wrapper of B3's launch that scales its result by 127/128 at one
    training step: the forward's (``role="forward"``, the launch over the
    batch's rows) or the table gradient's (``"table_grad"``, the launch
    over the wide table's rows)."""
    sound = embed_bag.launch
    calls = {"forward": 0, "table_grad": 0}

    def launch(rows, cols, values, table, n_rows):
        out = sound(rows, cols, values, table, n_rows)
        kind = "forward" if n_rows == WD["batch"] else "table_grad"
        calls[kind] += 1
        return out * (127 / 128) if kind == role and calls[kind] == step + 1 \
            else out
    return launch


WD_FAULT_STEP = 3  # of the K=8 block's steps 0..7


def recording(cls):
    """``cls`` (an optimization method) keeping float64 CPU copies of every
    step's parameters (as the step found them) and gradients in
    ``steps``."""
    class Recording(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.steps = []

        def update(self, grads, params, state, lr, step):
            self.steps.append(({k: p.detach().double().cpu()
                                for k, p in params.items()},
                               {k: g.detach().double().cpu()
                                for k, g in grads.items()}))
            super().update(grads, params, state, lr, step)
    return Recording


RecordingAdam = recording(optim.Adam)


def wd_cpu_step(init, params, batch, compute_dtype=None):
    """The loss and the gradients of one training step on the CPU (the
    plain versions), from ``params`` on ``batch``, computing in
    ``compute_dtype`` (default f32) as ``set_compute_dtype`` does."""
    m = copy.deepcopy(init)
    with torch.no_grad():
        for k, p in m.named_parameters():
            p.copy_(params[k])
            p.requires_grad_(True)
    coo, deep, dense = batch.input
    x = (coo, torch.from_numpy(deep), torch.from_numpy(dense))
    y = torch.from_numpy(batch.target)
    if compute_dtype is None:
        loss = SqueezedBCE().apply(m(x), y)
    else:
        loss = mixed_precision_loss_fn(m, SqueezedBCE(), compute_dtype)(
            dict(m.named_parameters()), x, y)
    loss.backward()
    return loss.item(), {k: p.grad.double() for k, p in m.named_parameters()}


def max_share(got, want, ref=None):
    """The largest difference as a share of the largest value of ``ref``
    (default ``want``)."""
    ref = want if ref is None else ref
    return (got - want).abs().max().item() / max(ref.abs().max().item(),
                                                 1e-300)


def norm_share(got, want, ref=None):
    """``||got - want|| / ||ref||`` (``ref`` default ``want``)."""
    ref = want if ref is None else ref
    return (got - want).norm().item() / max(ref.norm().item(), 1e-300)


def wd_step_reading(losses, steps, init, batches, cpu_step=wd_cpu_step,
                    share=max_share, first_scale=False):
    """How far a K-step card run is from the CPU, step by step: the weights
    the card started from against ``init`` (per array, the largest
    difference as a share of its largest value), and for each step j the
    relative difference of its loss and, per array, of its gradient (as a
    share of the array's largest gradient on the CPU; Inception's check
    passes ``norm_share``) from the same step on the CPU from the card's
    own weights of step j.  (reading, its four largest (share, what)).
    ``first_scale`` reads every step's differences against step 0's CPU
    loss and gradients, a scale that does not vanish as a run fits its
    data (the Tree-LSTM recipe's loss falls to 1e-6, where log-softmax's
    gradient 1 - p of a p within ulps of 1 is f32 cancellation on both
    devices).
    Per array, not per layer as in :func:`grad_reading`: no gradient here
    is a sum that nearly cancels (the sound readings of the card runs are
    a few 1e-7), and the wide weight's own gradient is held apart from
    the bias's.

    Step by step, not over the trained weights (the PTB check's reading,
    :func:`train_reading`, printed beside it): Adam moves each weight by
    about lr times the sign of its gradient, so a gradient within rounding
    of 0 on one device moves the other way on the other, and the trained
    weights of two sound runs differ by a share of training's change that
    swings from run to run with the signs that flip.  ``cpu_step`` redoes
    one step on the CPU (LeNet's check passes its own)."""
    start = flat_params(init)
    rows = [(max_share(steps[0][0][k], w), f"start {k}")
            for k, w in start.items()]
    for j, (params, grads) in enumerate(steps):
        loss, want = cpu_step(init, params, batches[j])
        if j == 0 or not first_scale:
            ref_loss, ref = loss, want
        rows.append((abs(losses[j] - loss) / abs(ref_loss),
                     f"step {j} loss"))
        rows += [(share(grads[k], w, ref[k]), f"step {j} {k}")
                 for k, w in want.items()]
    rows.sort(reverse=True)
    return rows[0][0], rows[:4]


def wd_check_phase(seed, device, card, report):
    """One K=8 block at the census dims on the card through LocalOptimizer
    against the CPU, step by step (:func:`wd_step_reading`), from the same
    port init and the same batches; and three planted faults on the card
    that must read above WD_TRAIN_TOL: the wide weight x127/128 at init,
    B3's forward result x127/128 at step WD_FAULT_STEP, and B3's table
    gradient x127/128 at that step.  The PTB check's reading of the trained
    weights (:func:`train_reading`) against a whole CPU run is printed
    beside it, not gated."""
    K, B = WD["K"], WD["batch"]
    batches = wd_batches(wd_data(K * B, seed + 1))
    init = wd_model(seed)

    def dataset():
        return DataSet.array(np.zeros(K * B)) >> Prebuilt(batches)

    def card_run(model, fault=None):
        adam = RecordingAdam(learning_rate=WD["lr"])
        sound_launch = embed_bag.launch
        if fault is not None:
            embed_bag.launch = planted_bag_fault(fault, WD_FAULT_STEP)
        try:
            losses = wd_train(model, dataset(), device, K, adam)[0]
        finally:
            embed_bag.launch = sound_launch
        return losses, adam.steps

    t0 = time.monotonic()
    cpu_model = copy.deepcopy(init)
    cpu_losses = wd_train(cpu_model, dataset(), "cpu", K)[0]
    cpu_s = time.monotonic() - t0
    card_model = copy.deepcopy(init)
    embed_bag.launches = 0
    card_losses, card_steps = card_run(card_model)
    if embed_bag.launches != 2 * K:
        raise AssertionError(f"B3 launched {embed_bag.launches} times in "
                             f"{K} steps (want 2 a step)")
    sound, worst = wd_step_reading(card_losses, card_steps, init, batches)
    weights_reading = train_reading(card_losses, card_model, cpu_losses,
                                    flat_params(cpu_model), flat_params(init))
    faults, fault_worst = {}, {}
    m = copy.deepcopy(init)
    with torch.no_grad():
        m.wide.weight.mul_(127 / 128)
    runs = {"wide_weight_127_128": (m, None)}
    for role in ("forward", "table_grad"):
        runs[f"b3_{role}_step{WD_FAULT_STEP}_127_128"] = (
            copy.deepcopy(init), role)
    for name, (m, role) in runs.items():
        faults[name], fault_worst[name] = wd_step_reading(
            *card_run(m, role), init, batches)
    print(f"wide-deep train-vs-cpu largest shares (share, what): sound "
          f"{worst}; " + "; ".join(f"{k} {v}" for k, v in
                                   fault_worst.items()))
    print(f"wide-deep train-vs-cpu check, {K} steps of batch {B} step by "
          f"step: sound {sound:.3e}, planted faults "
          + ", ".join(f"{k} {v:.3e}" for k, v in faults.items())
          + f" (tol {WD_TRAIN_TOL}); trained weights against a whole CPU "
          f"run (train_reading, not gated) {weights_reading:.3e}; cpu "
          f"losses " + ", ".join(f"{v:.6f}" for v in cpu_losses)
          + "; card losses " + ", ".join(f"{v:.6f}" for v in card_losses)
          + f"; the CPU's block took {cpu_s:.1f} s [{card}]")
    report["wide_deep_check"] = {"sound": sound, "largest": worst,
                                 "planted_faults": faults,
                                 "planted_largest": fault_worst,
                                 "weights_reading": weights_reading,
                                 "tol": WD_TRAIN_TOL,
                                 "cpu_losses": cpu_losses,
                                 "card_losses": card_losses}
    if not sound <= WD_TRAIN_TOL:
        raise AssertionError(f"Wide&Deep training on the card is "
                             f"{sound:.3e} from the CPU, over the limit "
                             f"{WD_TRAIN_TOL}")
    for fault, err in faults.items():
        if not err > WD_TRAIN_TOL:
            raise AssertionError(
                f"planted fault {fault} reads {err:.3e}, inside the "
                f"Wide&Deep training tolerance {WD_TRAIN_TOL}: the check is "
                f"blind")


def wd_profile_step(init, batch, device, card):
    """One training step (forward, backward, Adam update) of the census
    Wide&Deep under torch.profiler after a warm-up step."""
    net = copy.deepcopy(init).to(device).train()
    params = dict(net.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    adam = optim.Adam(learning_rate=WD["lr"])
    ostate = adam.init_state(params)
    coo, deep, dense = batch.input
    x = (coo.to(device), torch.from_numpy(deep).to(device),
         torch.from_numpy(dense).to(device))
    y = torch.from_numpy(batch.target).to(device)
    crit = SqueezedBCE()

    def step():
        for p in params.values():
            p.grad = None
        crit.apply(net(x), y).backward()
        adam.update({k: p.grad for k, p in params.items()}, params, ostate,
                    WD["lr"], 0)

    return profile_step(step, f"wide-deep train step (f32, batch "
                        f"{WD['batch']})", card, 8)


def wd_timed_phase(seed, device, card, report):
    """The census Wide&Deep on the card, timed twice: through the recipe's
    feed (SparseSamples >> SparseToMiniBatch, batch_sparse_samples in
    Python) and over batches built beforehand.  Each run: a warm-up block
    then WD["timed_blocks"] K=8 blocks; records/s and ms per step from the
    host clock at which each block's losses came back; B3's launches (2 a
    step); peak memory; block losses that must be finite and fall.  Then
    one profiled step."""
    K, B = WD["K"], WD["batch"]
    steps = K * (1 + WD["timed_blocks"])
    t0 = time.monotonic()
    cols = wd_data(steps * B, seed)
    samples = wd_samples(cols)
    batches = wd_batches(cols)
    print(f"wide-deep data: {len(samples)} records as SparseSamples and "
          f"{len(batches)} batches in {time.monotonic() - t0:.1f} s")
    init = wd_model(seed)
    datasets = {
        "recipe_feed": lambda: DataSet.array(samples) >> SparseToMiniBatch(),
        "prebuilt": lambda: DataSet.array(samples) >> Prebuilt(batches)}
    out, launches = {}, {}
    for name, make in datasets.items():
        t0 = time.monotonic()
        model = copy.deepcopy(init)
        torch.cuda.reset_peak_memory_stats()
        embed_bag.launches = 0
        losses, clock, opt, wall = wd_train(model, make(), device, steps)
        launches[name] = embed_bag.launches
        peak = torch.cuda.max_memory_allocated()
        if launches[name] != 2 * steps or opt.state["neval"] != steps:
            raise AssertionError(f"{name}: B3 launched {launches[name]} "
                                 f"times in {opt.state['neval']} steps "
                                 f"(want 2 a step)")
        blocks = [float(np.mean(losses[i:i + K]))
                  for i in range(0, steps, K)]
        if not (np.all(np.isfinite(losses)) and blocks[-1] < blocks[0]):
            raise AssertionError(f"{name}: the loss is not finite and "
                                 f"falling: {blocks}")
        ends = [clock[i + K - 1] for i in range(0, steps, K)]
        step_s = (ends[-1] - ends[0]) / (steps - K)
        out[name] = {"ms_per_step": step_s * 1e3,
                     "records_per_s": B / step_s, "block_losses": blocks,
                     "losses": losses, "max_memory_allocated": peak,
                     "launches": launches[name], "wall_s": wall}
        print(f"train wide-deep {name} f32 batch {B} K={K}: {steps} steps, "
              f"the {WD['timed_blocks']} blocks after the first: "
              f"ms_per_step={step_s * 1e3:.3f} records_per_s="
              f"{B / step_s:.1f} max_memory_allocated={peak} block losses "
              + ", ".join(f"{v:.4f}" for v in blocks)
              + f"; B3 launches {launches[name]} for {steps} steps; run "
              f"{time.monotonic() - t0:.1f} s [{card}]")
        del model, opt
    out["profile"] = wd_profile_step(init, batches[0], device, card)
    report["wide_deep_train"] = out
    return launches["recipe_feed"]


# ---------------------------------------------------------------- LeNet-5
# examples/lenet/train.py on one card: LeNet-5 (NCHW f32, its two 2x2/2
# pools' backward on B1's tiled_nchw variant) on synthetic MNIST at MNIST's
# own counts (60,000 training images, 10,000 validation images: a ragged
# last validation batch of 16), batch 128, the recipe's SGD (lr 0.05,
# momentum 0.9, no decay), K from Engine.steps_per_dispatch(), one epoch,
# Top-1/Top-5 every epoch, a snapshot every epoch, both summaries.
LENET = {"train": 60_000, "val": 10_000, "batch": 128, "lr": 0.05,
         "momentum": 0.9, "epochs": 1, "warmup_steps": 20, "check_K": 4,
         "resume_iters": 160, "resume_every": 50, "preempt_at": 120,
         "min_top1": 0.9}
# the card against the CPU, step by step (wd_step_reading) and on the
# validation log-probabilities: above the sound readings, below the two
# planted faults every run measures and requires to exceed it
LENET_TRAIN_TOL = 1e-3
_LENET_DATA = {}


def lenet_data():
    """(train, validation) (images, labels) of synthetic_mnist, made once."""
    if not _LENET_DATA:
        _LENET_DATA["train"] = mnist.synthetic_mnist(LENET["train"], seed=0)
        _LENET_DATA["val"] = mnist.synthetic_mnist(LENET["val"], seed=99)
    return _LENET_DATA["train"], _LENET_DATA["val"]


def lenet_pipeline(data, train, n=None, batch=None, distributed=False):
    """The recipe's pipeline over the first ``n`` images of ``data``:
    to_samples >> BytesToGreyImg >> GreyImgNormalizer >>
    SampleToMiniBatch(128, or ``batch``), the last batch kept for
    validation; ``distributed``: this process's shard."""
    imgs, labels = data
    mean, std = (mnist.TRAIN_MEAN, mnist.TRAIN_STD) if train \
        else (mnist.TEST_MEAN, mnist.TEST_STD)
    return (DataSet.array(mnist.to_samples(imgs[:n], labels[:n]),
                          distributed=distributed)
            >> image.BytesToGreyImg() >> image.GreyImgNormalizer(mean, std)
            >> SampleToMiniBatch(batch or LENET["batch"],
                                 drop_remainder=train))


def lenet_b1_launches(what):
    """B1's launches since the last reset, every one tiled_nchw (LeNet's
    NCHW pools), else an AssertionError naming ``what``."""
    if maxpool.variant_launches["tiled_nchw"] != maxpool.launches:
        raise AssertionError(f"{what}: B1 {maxpool.variant_launches}, want "
                             f"every launch tiled_nchw")
    return maxpool.launches


def lenet_sgd(cls=optim.SGD):
    return cls(learning_rate=LENET["lr"], learning_rate_decay=0.0,
               momentum=LENET["momentum"])


def lenet_pool_phase(device, card, report):
    """B1 at LeNet's two pools: bitwise against its plain version on
    integer inputs (ties) in tiled_nchw, then on tanh outputs its device
    time beside the bound, the plain version and the library's
    ``max_pool2d_with_indices_backward``."""
    gen = torch.Generator(device=device).manual_seed(3141)
    rows = {}
    for name in LENET_POOL_CASES:
        case = next(c for c in POOL_CASES if c[0] == name)
        pool_case_check(case, gen, device)
        shape, k, s, p, ceil, fmt, dtype = case[1:8]
        x, y, g, pads, kk, ss = pool_operands(shape, k, s, p, ceil, fmt,
                                              dtype, "tanh", gen, device)
        _, ind = torch.nn.functional.max_pool2d(x, k, s, p,
                                                return_indices=True)
        geo = (kk, ss, pads)
        fns = (lambda: maxpool.launch(x, y, g, *geo),
               lambda: maxpool.maxpool_bwd_reference(x, y, g, *geo),
               lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                   g, x, [k, k], [s, s], [p, p], [1, 1], False, ind))
        got, want = fns[0](), fns[1]()
        variant = maxpool.last_variant
        if variant[0] != "tiled_nchw":
            raise AssertionError(f"B1 {name}: took {variant}")
        err = (got.float() - want.float()).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"B1 {name} on the timed inputs: max abs "
                                 f"err {err} against its plain version")
        # no window overlaps another: each position takes at most one
        # gradient, so the library's gi is B1's unless a window ties
        lib = fns[2]()
        torch.testing.assert_close(lib, got, rtol=0, atol=0)
        passes = []
        k_ms = device_ms(fns[0], calls=50, split=passes)
        l_ms = device_ms(fns[2], calls=50)
        k_ev, p_ev, l_ev = (cuda_ms(f, budget_ms=50.0) for f in fns)
        b_ms, b_by, nbytes = pool_bound(shape, y.shape, dtype)
        rows[name] = {"ms": k_ms, "plain_ms": p_ev, "library_ms": l_ms,
                      "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                      "max_abs_err": err, "event_ms": k_ev,
                      "library_event_ms": l_ev, "passes": passes,
                      "variant": list(variant)}
        print(f"maxpool_bwd {name} x {tuple(x.shape)} {variant[0]} "
              f"(blocks {variant[3]}): max_abs_err={err} against the plain "
              f"version, library equal; device ms per call kernel_ms="
              f"{k_ms:.5f} library_ms={l_ms:.5f}; event-timed kernel "
              f"{k_ev:.5f} plain {p_ev:.5f} library {l_ev:.5f}; bound_ms="
              f"{b_ms:.5f} ({b_by}: {nbytes / 1e6:.3f} MB at "
              f"{HBM_BPS / 1e12:.2f} TB/s); by kernel: "
              + ", ".join(f"{kernel_pass(n)} {ms:.5f}" for n, ms in passes)
              + f" [{card}]")
        del x, y, g, ind, got, want, lib
    report["lenet_pool"] = rows
    return rows


def lenet_profile_step(init, batch, device, card):
    """One training step (forward, backward, SGD update) of LeNet-5 at
    batch 128 under torch.profiler after a warm-up step."""
    net = copy.deepcopy(init).to(device).train()
    params = dict(net.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    sgd = lenet_sgd()
    ostate = sgd.init_state(params)
    x = torch.from_numpy(batch.input).to(device)
    y = torch.from_numpy(batch.target).to(device)
    crit = nn.ClassNLLCriterion()

    def step():
        for p in params.values():
            p.grad = None
        crit.apply(net(x), y).backward()
        sgd.update({k: p.grad for k, p in params.items()}, params, ostate,
                   LENET["lr"], 0)

    return profile_step(step, f"lenet train step (f32, batch "
                        f"{LENET['batch']})", card, 8)


def timed_commits(sound):
    """A wrapper of the checkpoint manager's writer ``sound`` that records
    (file, commit ms, bytes on disk) of each snapshot it commits."""
    commits = []

    def write(path, **kw):
        t0 = time.perf_counter()
        out = sound(path, **kw)
        commits.append((os.path.basename(path),
                        (time.perf_counter() - t0) * 1e3,
                        os.path.getsize(path)))
        return out
    return write, commits


def lenet_timed_phase(seed, device, card, report):
    """The LeNet recipe on the card: an epoch of synthetic MNIST through
    LocalOptimizer with validation, snapshots and both summaries.  Prints
    samples/s and ms a step (host clock at replay, epoch 1 after its first
    steps, validation and snapshots left out), peak memory, Top-1/Top-5
    after each epoch, each snapshot's commit ms and bytes; fails unless
    Top-1 after the last epoch exceeds LENET["min_top1"], the loss falls
    and B1 launched 2 a step, all tiled_nchw (validation runs the forward
    only).  Then one profiled step."""
    t0 = time.monotonic()
    train, val = lenet_data()
    print(f"lenet data: synthetic_mnist {len(train[1])} training and "
          f"{len(val[1])} validation images in {time.monotonic() - t0:.1f} s")
    init = lenet5(10).initialize(seed)
    model = copy.deepcopy(init)
    losses, clock, scores = [], [], []

    class Recording(LocalOptimizer):
        def _log_train_iteration(self, lr):
            losses.append(self.state["loss"])
            clock.append(time.perf_counter())

        def _run_validation(self, run):
            t = time.perf_counter()
            res = super()._run_validation(run)
            if res is not None:
                scores.append({"neval": self.state["neval"],
                               "top1": res["Top1Accuracy"].result,
                               "top5": res["Top5Accuracy"].result,
                               "count": res["Top1Accuracy"].count,
                               "s": time.perf_counter() - t})
            return res

    sound_write = ckpt_manager.write_snapshot
    write, commits = timed_commits(sound_write)
    K = Engine.steps_per_dispatch()
    with tempfile.TemporaryDirectory() as tmp:
        opt = (Recording(model, lenet_pipeline(train, True),
                         nn.ClassNLLCriterion(), device=device)
               .set_optim_method(lenet_sgd())
               .set_end_when(optim.max_epoch(LENET["epochs"]))
               .set_validation(optim.every_epoch(),
                               lenet_pipeline(val, False),
                               [optim.Top1Accuracy(), optim.Top5Accuracy()])
               .set_checkpoint(tmp, optim.every_epoch())
               .set_train_summary(TrainSummary(tmp, "lenet"))
               .set_val_summary(ValidationSummary(tmp, "lenet")))
        torch.cuda.reset_peak_memory_stats()
        maxpool.reset_counts()
        ckpt_manager.write_snapshot = write
        t1 = time.monotonic()
        try:
            opt.optimize()
        finally:
            ckpt_manager.write_snapshot = sound_write
        wall = time.monotonic() - t1
        peak = torch.cuda.max_memory_allocated()
        opt.train_summary.close()
        opt.validation_summary.close()
        events = {phase: sum(os.path.getsize(os.path.join(d, f))
                             for d, _, fs in os.walk(os.path.join(
                                 tmp, "lenet", phase)) for f in fs)
                  for phase in ("train", "validation")}
        stall = opt.registry.histogram("checkpoint/driver_stall_s").snapshot()
    steps = opt.state["neval"]
    launches = maxpool.launches
    per_epoch = -(-LENET["train"] // LENET["batch"])
    if steps != LENET["epochs"] * per_epoch or launches != 2 * steps \
            or maxpool.variant_launches["tiled_nchw"] != launches:
        raise AssertionError(f"lenet: {steps} steps, B1 launched {launches} "
                             f"times ({maxpool.variant_launches}); want "
                             f"{LENET['epochs'] * per_epoch} steps, 2 "
                             f"tiled_nchw launches a step")
    w = LENET["warmup_steps"]
    step_s = (clock[per_epoch - 1] - clock[w]) / (per_epoch - 1 - w)
    first, last = np.mean(losses[:w]), np.mean(losses[-w:])
    print(f"train lenet f32 batch {LENET['batch']} K={K}: {steps} steps in "
          f"{LENET['epochs']} epochs, {wall:.2f} s with validation and "
          f"snapshots; epoch 1's steps {w}..{per_epoch - 1}: ms_per_step="
          f"{step_s * 1e3:.3f} samples_per_s={LENET['batch'] / step_s:.1f}"
          f" max_memory_allocated={peak}; mean loss of the first / last "
          f"{w} steps {first:.4f} / {last:.4f}; B1 launches {launches} "
          f"({maxpool.variant_launches}) [{card}]")
    for s in scores:
        print(f"lenet validation after iteration {s['neval']}: Top1Accuracy="
              f"{s['top1']:.4f} Top5Accuracy={s['top5']:.4f} over "
              f"{int(s['count'])} images in {s['s'] * 1e3:.1f} ms [{card}]")
    for name, ms, nbytes in commits:
        print(f"lenet snapshot {name}: commit_ms={ms:.2f} bytes={nbytes} "
              f"(the writer thread: serialize, CRC32-C, fsync, rename)")
    print(f"lenet checkpoint driver stall per save (copy to the host and "
          f"enqueue): {stall}; event files {events} bytes")
    if len(scores) != LENET["epochs"] or len(commits) != LENET["epochs"]:
        raise AssertionError(f"lenet: {len(scores)} validations and "
                             f"{len(commits)} snapshots in "
                             f"{LENET['epochs']} epochs")
    if scores[-1]["count"] != LENET["val"]:
        raise AssertionError(f"lenet validation scored "
                             f"{scores[-1]['count']} of {LENET['val']}")
    if not scores[-1]["top1"] > LENET["min_top1"]:
        raise AssertionError(f"lenet Top-1 {scores[-1]['top1']:.4f} after "
                             f"{LENET['epochs']} epochs, want > "
                             f"{LENET['min_top1']}")
    if not (np.all(np.isfinite(losses)) and last < first):
        raise AssertionError(f"lenet: the loss is not finite and falling "
                             f"({first} -> {last})")
    profile = lenet_profile_step(
        init, next(iter(lenet_pipeline(train, True).data(train=False))),
        device, card)
    report["lenet_train"] = {
        "steps": steps, "K": K, "wall_s": wall, "ms_per_step": step_s * 1e3,
        "samples_per_s": LENET["batch"] / step_s, "max_memory_allocated":
        peak, "losses": losses, "validations": scores,
        "snapshots": commits, "driver_stall": stall, "event_bytes": events,
        "launches": launches, "profile": profile}
    return launches


def lenet_cpu_step(init, params, batch):
    """The loss and the gradients of one LeNet step on the CPU (the plain
    versions), from ``params`` on ``batch``."""
    m = copy.deepcopy(init)
    with torch.no_grad():
        for k, p in m.named_parameters():
            p.copy_(params[k])
            p.requires_grad_(True)
    loss = nn.ClassNLLCriterion().apply(m(torch.from_numpy(batch.input)),
                                        torch.from_numpy(batch.target))
    loss.backward()
    return loss.item(), {k: p.grad.double() for k, p in m.named_parameters()}


def lenet_logp_reading(model, batches, device):
    """The validation log-probabilities of ``model``'s weights on the card
    against the CPU: the largest difference as a share of max|logp|, over
    ``batches`` (the first and the ragged last)."""
    card = copy.deepcopy(model).to(device).eval()
    cpu = copy.deepcopy(model).eval()
    worst = 0.0
    with torch.no_grad():
        for b in batches:
            x = torch.from_numpy(b.input)
            want = cpu(x)
            got = card(x.to(device)).cpu()
            worst = max(worst, ((got - want).abs().max()
                                / want.abs().max()).item())
    return worst


def lenet_check_phase(seed, device, card, report):
    """One K=LENET["check_K"] block of the recipe on the card through
    LocalOptimizer against the CPU, step by step (wd_step_reading with
    lenet_cpu_step), from
    the same init and batches, and the validation log-probabilities of the
    trained weights on both (lenet_logp_reading); two planted faults on
    the card must read above LENET_TRAIN_TOL: fc1's weight x127/128 at
    init, and B1's first launch x127/128."""
    K, B = LENET["check_K"], LENET["batch"]
    train, val = lenet_data()
    batches = list(lenet_pipeline(train, True, K * B).data(train=False))
    vbatches = list(lenet_pipeline(val, False).data(train=False))
    vbatches = [vbatches[0], vbatches[-1]]
    init = lenet5(10).initialize(seed + 1)

    def card_run(model, b1_fault=False):
        sgd = lenet_sgd(recording(optim.SGD))
        sound_launch = maxpool.launch
        if b1_fault:
            maxpool.launch = planted_b1_fault()
        try:
            losses = []
            opt = (LocalOptimizer(model, lenet_pipeline(train, True, K * B),
                                  nn.ClassNLLCriterion(), device=device)
                   .set_optim_method(sgd).set_steps_per_dispatch(K)
                   .set_end_when(optim.max_iteration(K)))
            opt._log_train_iteration = \
                lambda lr: losses.append(opt.state["loss"])
            opt.optimize()
        finally:
            maxpool.launch = sound_launch
        return losses, sgd.steps

    card_model = copy.deepcopy(init)
    maxpool.reset_counts()
    card_losses, card_steps = card_run(card_model)
    if lenet_b1_launches("lenet check") != 2 * K:
        raise AssertionError(f"B1 launched {maxpool.launches} times in {K} "
                             f"steps (want 2 a step)")
    sound, worst = wd_step_reading(card_losses, card_steps, init, batches,
                                   lenet_cpu_step)
    logp = lenet_logp_reading(card_model, vbatches, device)
    faults, fault_worst = {}, {}
    m = copy.deepcopy(init)
    with torch.no_grad():
        m[8].weight.mul_(127 / 128)
    for name, (model, b1) in {"fc1_weight_127_128": (m, False),
                              "b1_first_launch_127_128": (
                                  copy.deepcopy(init), True)}.items():
        faults[name], fault_worst[name] = wd_step_reading(
            *card_run(model, b1), init, batches, lenet_cpu_step)
    print(f"lenet train-vs-cpu largest shares (share, what): sound {worst}; "
          + "; ".join(f"{k} {v}" for k, v in fault_worst.items()))
    print(f"lenet train-vs-cpu check, {K} steps of batch {B} step by step: "
          f"sound {sound:.3e}, validation log-probs {logp:.3e} (batches of "
          f"{vbatches[0].size()} and {vbatches[1].size()}), planted faults "
          + ", ".join(f"{k} {v:.3e}" for k, v in faults.items())
          + f" (tol {LENET_TRAIN_TOL}); card losses "
          + ", ".join(f"{v:.6f}" for v in card_losses) + f" [{card}]")
    report["lenet_check"] = {"sound": sound, "largest": worst,
                             "logp": logp, "planted_faults": faults,
                             "planted_largest": fault_worst,
                             "tol": LENET_TRAIN_TOL,
                             "card_losses": card_losses}
    if not max(sound, logp) <= LENET_TRAIN_TOL:
        raise AssertionError(f"LeNet on the card is {sound:.3e} (training) / "
                             f"{logp:.3e} (validation log-probs) from the "
                             f"CPU, over the limit {LENET_TRAIN_TOL}")
    for fault, err in faults.items():
        if not err > LENET_TRAIN_TOL:
            raise AssertionError(
                f"planted fault {fault} reads {err:.3e}, inside the LeNet "
                f"training tolerance {LENET_TRAIN_TOL}: the check is blind")


def lenet_resume_run(ckpt, k, device, preempt_at=None, resume=False):
    """The recipe for LENET["resume_iters"] iterations at K=``k`` with a
    snapshot every LENET["resume_every"] into ``ckpt``: ({step: loss},
    optimizer).  ``preempt_at``: the process sends itself SIGTERM while
    that iteration is replayed (preemption handling on); ``resume``:
    resume() from ``ckpt`` first."""
    train, _ = lenet_data()
    losses = {}

    class Recording(LocalOptimizer):
        def _log_train_iteration(self, lr):
            losses[self.state["neval"]] = self.state["loss"]
            if self.state["neval"] == preempt_at:
                if not self._preemption.installed:
                    raise AssertionError("the SIGTERM handler is not "
                                         "installed")
                os.kill(os.getpid(), signal.SIGTERM)

    opt = (Recording(lenet5(10).initialize(7), lenet_pipeline(train, True),
                     nn.ClassNLLCriterion(), device=device)
           .set_optim_method(lenet_sgd()).set_steps_per_dispatch(k)
           .set_end_when(optim.max_iteration(LENET["resume_iters"]))
           .set_checkpoint(ckpt, optim.several_iteration(
               LENET["resume_every"])))
    if preempt_at is not None:
        opt.set_preemption_handling()
    if resume and not opt.resume():
        raise AssertionError(f"no valid snapshot to resume under {ckpt}")
    start = opt.state["neval"]
    opt.optimize()
    return losses, opt, start


def lenet_resume_phase(device, card, report):
    """Bitwise resume on the card, under torch.use_deterministic_algorithms:
    at K=1 and K=4, an uninterrupted run against a run that a SIGTERM cuts
    mid-epoch (preemption handling: the block in flight finishes, a last
    snapshot is written) and a fresh optimizer's resume() of it: the
    spliced losses and the final weights must equal the uninterrupted
    run's bitwise.  At K=4 the preemption's snapshot is truncated on disk
    first, so latest_valid must skip it and the resume starts from the
    last trigger snapshot."""
    out = {}
    torch.use_deterministic_algorithms(True)
    try:
        for k in (1, 4):
            with tempfile.TemporaryDirectory() as tmp:
                t0 = time.monotonic()
                ref, ref_opt, _ = lenet_resume_run(
                    os.path.join(tmp, "ref"), k, device)
                cut_dir = os.path.join(tmp, "cut")
                first, cut_opt, _ = lenet_resume_run(
                    cut_dir, k, device, preempt_at=LENET["preempt_at"])
                stop = cut_opt.state["neval"]
                if not cut_opt.state.get("preempted") or \
                        not LENET["preempt_at"] <= stop < \
                        LENET["resume_iters"]:
                    raise AssertionError(f"K={k}: the SIGTERM at iteration "
                                         f"{LENET['preempt_at']} did not "
                                         f"preempt the run ({cut_opt.state})")
                mgr = ckpt_manager.CheckpointManager(cut_dir)
                torn = None
                if k == 4:
                    torn = mgr.path_for(stop)
                    with open(torn, "r+b") as f:
                        f.truncate(os.path.getsize(torn) // 2)
                latest = mgr.latest_valid()
                mgr.unpin()
                want = mgr.path_for(LENET["preempt_at"] // LENET[
                    "resume_every"] * LENET["resume_every"]) if torn \
                    else mgr.path_for(stop)
                if latest != want:
                    raise AssertionError(f"K={k}: latest_valid gave "
                                         f"{latest}, want {want}")
                second, res_opt, start = lenet_resume_run(
                    cut_dir, k, device, resume=True)
                spliced = {**first, **second}
                same = sorted(spliced) == sorted(ref) and all(
                    spliced[s] == ref[s] for s in ref)
                params_same = all(torch.equal(a, b) for a, b in zip(
                    res_opt.model.parameters(), ref_opt.model.parameters()))
                print(f"lenet resume K={k}: SIGTERM at iteration "
                      f"{LENET['preempt_at']}, stopped at {stop}"
                      + (f", its snapshot truncated and skipped" if torn
                         else "") + f", resumed from {start} to "
                      f"{res_opt.state['neval']}: losses bitwise {same}, "
                      f"weights bitwise {params_same} "
                      f"({time.monotonic() - t0:.1f} s) [{card}]")
                out[k] = {"stop": stop, "resumed_from": start,
                          "torn": torn is not None, "losses_equal": same,
                          "weights_equal": params_same}
                if not (same and params_same):
                    worst = max(abs(spliced.get(s, float("nan")) - ref[s])
                                for s in ref)
                    raise AssertionError(
                        f"K={k}: the resumed run is not bitwise the "
                        f"uninterrupted one (largest loss difference "
                        f"{worst})")
    finally:
        torch.use_deterministic_algorithms(False)
    report["lenet_resume"] = out


# ------------------------------------------------ DistriOptimizer (slice 9)
# the recipe's DistriOptimizer runs at world 1 over NCCL (one card); the
# world-2 check runs two processes on the one card over gloo (NCCL refuses
# two ranks on one device)
DISTRI = {"pipeline_blocks": 1, "world2": 2, "world2_batch": 64,
          "world2_steps": 8, "resume_images": 16 * 128, "resume_iters": 12,
          "resume_every": 4}
# how far the bf16 wire's f32 masters may stray from the f32 wire's
# weights: the worst leaf's ||w_bf16 - w_f32|| / ||w_f32 - w_0||.  At the
# world-2 check's LeNet the sound wire reads about 0.01 and a wire that
# never updates the weights 1.0 (PERF.md section 2)
WIRE_DRIFT_LIMIT = 0.1
SYNC_PHASES = ("flatten", "wire_cast", "reduce_scatter", "update",
               "all_gather", "unflatten")


def distri_optimizer(model, dataset, device, wire, k, steps, method,
                     compute=None, **kw):
    """The optimizer ``Optimizer.create(..., distributed=True)`` builds,
    recording each step's loss and the host clock at its replay in
    ``opt.losses`` / ``opt.clock``."""
    opt = (optim.Optimizer.create(model, dataset, nn.ClassNLLCriterion(),
                                  distributed=True, device=device,
                                  grad_wire_dtype=wire, **kw)
           .set_optim_method(method).set_compute_dtype(compute)
           .set_steps_per_dispatch(k)
           .set_end_when(optim.max_iteration(steps)))
    opt.losses, opt.clock = [], []

    def log(lr):
        opt.losses.append(opt.state["loss"])
        opt.clock.append(time.perf_counter())
    opt._log_train_iteration = log
    return opt


def sync_phase_kernels(prof):
    """{phase: {kernel: [device ms, launches]}} of the kernels that the
    ``grad_sync.<phase>`` ranges of a profiled step launched: the kernels
    of each host-side range's operations (the range's own device-side
    span, which covers the gaps between them, is left out)."""
    out = {ph: {} for ph in SYNC_PHASES}

    def walk(evt, acc):
        for k in evt.kernels:
            row = acc.setdefault(k.name, [0.0, 0])
            row[0] += k.duration / 1e3
            row[1] += 1
        for ch in evt.cpu_children:
            walk(ch, acc)

    for evt in prof.events():
        ph = evt.name[len("grad_sync."):] \
            if evt.name.startswith("grad_sync.") else None
        if ph in out and evt.device_type.name == "CPU":
            for ch in evt.cpu_children:
                walk(ch, out[ph])
    return out


def distri_profile_step(init, augmented, device, card, wire):
    """The recipe's second step through DistriOptimizer (K=1) under
    torch.profiler: wall ms, device busy ms, idle share, launches, and the
    sync's own device ms by phase (the kernels of the ``grad_sync.<phase>``
    ranges)."""
    from torch.profiler import ProfilerActivity, profile
    B = RESNET["batch"]
    opt = distri_optimizer(copy.deepcopy(init),
                           DataSet.array(augmented) >> SampleToMiniBatch(B),
                           device, wire, 1, 2,
                           recipe_sgd(RESNET["samples"] // B), torch.bfloat16)
    sound_block, out = opt._block, {}

    def block(step_fn, staged, lrs, first_step):
        if first_step != 1:
            return sound_block(step_fn, staged, lrs, first_step)
        staged.wait()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.monotonic()
            losses = sound_block(step_fn, staged, lrs, first_step)
            torch.cuda.synchronize()
            out["wall_ms"] = (time.monotonic() - t1) * 1e3
        busy, kernels, _ = device_time(prof)
        phases = sync_phase_kernels(prof)
        out.update(device_busy_ms=busy,
                   kernel_launches=sum(n for _, _, n in kernels),
                   sync_ms={ph: sum(ms for ms, _ in ks.values())
                            for ph, ks in phases.items()},
                   sync_launches={ph: sum(n for _, n in ks.values())
                                  for ph, ks in phases.items()},
                   sync_kernels={ph: sorted(([k[:60], ms, n] for k, (ms, n)
                                             in ks.items()),
                                            key=lambda r: -r[1])[:4]
                                 for ph, ks in phases.items()},
                   nccl_ms=sum(ms for name, ms, _ in kernels
                               if "nccl" in name.lower()),
                   top=[list(k) for k in kernels[:8]])
        return losses
    opt._block = block
    opt.optimize()
    sync = sum(out["sync_ms"].values())
    idle = "not measured (the profiler saw no device time)" \
        if out["device_busy_ms"] == 0 else \
        f"{max(0.0, 1 - out['device_busy_ms'] / out['wall_ms']):.3f}"
    print(f"profile distri resnet50 step ({wire} wire, world 1 "
          f"{opt.mesh.backend}): "
          f"wall_ms={out['wall_ms']:.2f} device_busy_ms="
          f"{out['device_busy_ms']:.2f} idle_share={idle} kernel_launches="
          f"{out['kernel_launches']}; sync device ms {sync:.3f} in "
          f"{sum(out['sync_launches'].values())} launches: "
          + ", ".join(f"{ph} {ms:.3f} ({out['sync_launches'][ph]})"
                      for ph, ms in out["sync_ms"].items())
          + f" (nccl kernels {out['nccl_ms']:.3f}) [{card}]")
    for ph, rows in out["sync_kernels"].items():
        for name, ms, n in rows:
            print(f"  {ph:>14s} {ms:8.3f} ms x{n:<4d} {name}")
    return out


def distri_resnet_phase(seed, device, card, report):
    """ResNet-50's ImageNet recipe through Optimizer.create(...,
    distributed=True) at world 1 over NCCL, with the f32 wire, then the
    bf16 wire: each a warm-up block and RESNET["timed_blocks"] timed K=4
    blocks over the pre-augmented images, then with the f32 wire a warm-up
    and DISTRI["pipeline_blocks"] timed blocks through the recipe's
    pipeline, which bounds both wires alike (images/s, ms a step from the
    host clock at each block's replay), block losses that must be finite
    and fall, peak memory, the bucket count, B1's launches (one a step,
    bf16, tiled_nhwc); then one profiled step a wire.  Returns B1's
    launches in the f32 pre-augmented run (counts set to 0 just before
    it)."""
    B, K, size = RESNET["batch"], RESNET["K"], RESNET["size"]
    per_epoch = RESNET["samples"] // B
    samples, augmented = resnet_data()
    init = resnet50(RESNET["classes"], format="NHWC").initialize(seed)
    runs = {
        "pre_augmented": (lambda: DataSet.array(augmented)
                          >> SampleToMiniBatch(B),
                          K * (1 + RESNET["timed_blocks"])),
        "pipeline": (lambda: DataSet.array(samples) >> MTSampleToMiniBatch(
            B, recipe_augment(size), workers=RESNET["workers"]),
            K * (1 + DISTRI["pipeline_blocks"]))}
    out, main_launches = {}, None
    for wire in ("f32", "bf16"):
        for name, (make, steps) in runs.items():
            if wire == "bf16" and name == "pipeline":
                continue
            t0 = time.monotonic()
            opt = distri_optimizer(copy.deepcopy(init), make(), device, wire,
                                   K, steps, recipe_sgd(per_epoch),
                                   torch.bfloat16)
            torch.cuda.reset_peak_memory_stats()
            maxpool.reset_counts()
            opt.optimize()
            launches = maxpool.launches
            peak = torch.cuda.max_memory_allocated()
            losses, clock = opt.losses, opt.clock
            if launches != steps or opt.state["neval"] != steps or \
                    maxpool.variant_launches["tiled_nhwc"] != steps:
                raise AssertionError(
                    f"distri {wire} {name}: B1 launched {launches} times "
                    f"({maxpool.variant_launches}) in "
                    f"{opt.state['neval']} steps")
            if wire == "f32" and name == "pre_augmented":
                main_launches = launches
            blocks = [float(np.mean(losses[i:i + K]))
                      for i in range(0, steps, K)]
            if not (np.all(np.isfinite(losses)) and blocks[-1] < blocks[0]):
                raise AssertionError(f"distri {wire} {name}: the loss is "
                                     f"not finite and falling: {blocks}")
            plan = opt._gs_plan
            if not opt._use_grad_sync or opt._world != 1 or \
                    opt.mesh.backend != ("nccl" if device.type == "cuda"
                                         else "gloo"):
                raise AssertionError(f"distri {wire} {name}: not the "
                                     f"world-1 nccl grad_sync path")
            ends = [clock[i + K - 1] for i in range(0, steps, K)]
            step_s = (ends[-1] - ends[0]) / (steps - K)
            out[f"{wire}/{name}"] = {
                "ms_per_step": step_s * 1e3, "images_per_s": B / step_s,
                "block_losses": blocks, "losses": losses,
                "max_memory_allocated": peak, "launches": launches,
                "buckets": plan.num_buckets,
                "bucket_sizes": plan.bucket_sizes,
                "wall_s": time.monotonic() - t0}
            print(f"train resnet50 distri world 1 {opt.mesh.backend} {wire} "
                  f"wire {name} "
                  f"NHWC bf16 batch {B} K={K}: {steps} steps, the "
                  f"{steps // K - 1} blocks after the first: ms_per_step="
                  f"{step_s * 1e3:.2f} images_per_s={B / step_s:.1f} "
                  f"max_memory_allocated={peak} buckets={plan.num_buckets} "
                  f"(largest {max(plan.bucket_sizes)} elements) block losses "
                  + ", ".join(f"{v:.4f}" for v in blocks)
                  + f"; B1 launches {launches} for {steps} steps, all bf16 "
                  f"tiled_nhwc; run {time.monotonic() - t0:.1f} s [{card}]")
            del opt
            torch.cuda.empty_cache()
        out[f"{wire}/profile"] = distri_profile_step(init, augmented, device,
                                                     card, wire)
        torch.cuda.empty_cache()
    report["distri_resnet"] = out
    return main_launches


def params_equal(a, b):
    return all(torch.equal(x.detach().cpu(), y.detach().cpu())
               for x, y in zip(a.parameters(), b.parameters()))


def distri_vs_local_phase(seed, device, card, report):
    """World 1 against LocalOptimizer on the card, same seed, weights and
    data, one K=4 block, f32 wire: LeNet-5 (the recipe, under
    torch.use_deterministic_algorithms) and ResNet-50 (the recipe, bf16
    compute, cuDNN's deterministic algorithms) must give the same losses
    and weights bit for bit."""
    out = {}
    K, B = LENET["check_K"], LENET["batch"]
    train, _ = lenet_data()
    init = lenet5(10).initialize(seed + 1)
    torch.use_deterministic_algorithms(True)
    try:
        local = copy.deepcopy(init)
        llosses = []
        lopt = (LocalOptimizer(local, lenet_pipeline(train, True, K * B),
                               nn.ClassNLLCriterion(), device=device)
                .set_optim_method(lenet_sgd()).set_steps_per_dispatch(K)
                .set_end_when(optim.max_iteration(K)))
        lopt._log_train_iteration = \
            lambda lr: llosses.append(lopt.state["loss"])
        lopt.optimize()
        dist_model = copy.deepcopy(init)
        dopt = distri_optimizer(dist_model, lenet_pipeline(train, True, K * B),
                                device, "f32", K, K, lenet_sgd())
        dopt.optimize()
    finally:
        torch.use_deterministic_algorithms(False)
    same = llosses == dopt.losses and params_equal(local, dist_model)
    print(f"lenet distri world 1 vs LocalOptimizer, K={K} block of batch "
          f"{B}: losses and weights bitwise {same} (buckets "
          f"{dopt._gs_plan.num_buckets}); losses "
          + ", ".join(f"{v:.6f}" for v in dopt.losses) + f" [{card}]")
    out["lenet"] = {"bitwise": same, "losses": dopt.losses}
    if not same:
        raise AssertionError(f"LeNet through DistriOptimizer at world 1 is "
                             f"not LocalOptimizer bit for bit: "
                             f"{dopt.losses} vs {llosses}")
    K, B = RESNET["K"], RESNET["batch"]
    _, augmented = resnet_data()
    init = resnet50(RESNET["classes"], format="NHWC").initialize(seed)
    per_epoch = RESNET["samples"] // B
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        local = copy.deepcopy(init)
        llosses, _, lopt, _ = resnet_train(
            local, DataSet.array(augmented) >> SampleToMiniBatch(B), device,
            K, K, torch.bfloat16, per_epoch)
        del lopt
        dist_model = copy.deepcopy(init)
        dopt = distri_optimizer(dist_model, DataSet.array(augmented)
                                >> SampleToMiniBatch(B), device, "f32", K, K,
                                recipe_sgd(per_epoch), torch.bfloat16)
        dopt.optimize()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            cudnn
    same = llosses == dopt.losses and params_equal(local, dist_model)
    worst = max(((a.detach() - b.detach()).abs().max()
                 / b.detach().abs().max().clamp(min=1e-30)).item()
                for a, b in zip(dist_model.parameters(), local.parameters()))
    print(f"resnet50 distri world 1 vs LocalOptimizer, K={K} block of batch "
          f"{B} bf16: losses and weights bitwise {same} (largest weight "
          f"difference {worst:.3e} of a layer's largest; buckets "
          f"{dopt._gs_plan.num_buckets}); losses "
          + ", ".join(f"{v:.6f}" for v in dopt.losses) + f" [{card}]")
    out["resnet50"] = {"bitwise": same, "losses": dopt.losses,
                       "local_losses": llosses, "largest": worst}
    report["distri_vs_local"] = out
    if not same:
        raise AssertionError("ResNet-50 through DistriOptimizer at world 1 "
                             "is not LocalOptimizer bit for bit")


WIRE_FAULTS = ("no_update", "stale_gather")


@contextlib.contextmanager
def planted_wire_fault(kind):
    """A deliberately broken wire that the bf16 check must fail:
    ``"no_update"`` (the reduce-scatter delivers zeros, so the weights
    never move) or ``"stale_gather"`` (the all-gather keeps publishing its
    first parameters); None: the sound wire."""
    from bigdl_tpu_torch.parallel import grad_sync
    saved = (grad_sync.reduce_scatter_grads, grad_sync.all_gather_params)
    if kind == "no_update":
        grad_sync.reduce_scatter_grads = lambda *a, **k: [
            torch.zeros_like(o) for o in saved[0](*a, **k)]
    elif kind == "stale_gather":
        first = []

        def stale(*a, **k):
            new = saved[1](*a, **k)
            first.extend(p.clone() for p in new[len(first):])
            return [p.clone() for p in first]
        grad_sync.all_gather_params = stale
    try:
        yield
    finally:
        grad_sync.reduce_scatter_grads, grad_sync.all_gather_params = saved


def wire_drift(params, ref, start):
    """How far a run's weights strayed from the f32 wire's: the worst
    leaf's ``||w - w_f32|| / ||w_f32 - w_0||``."""
    return max(float(np.linalg.norm(params[k] - ref[k])
                     / np.linalg.norm(ref[k] - start[k])) for k in ref)


def bf16_neighbours(run):
    """Whether every weight a bf16-wire run published is one of the two
    bf16 values around its f32 master: what the all-gather's unbiased
    round may give."""
    ok = True
    for pub, master in zip(run["flat"], run["full_masters"]):
        bits = master.view(np.uint32) & 0xFFFF0000
        down, up = bits.view(np.float32), (bits + 0x10000).view(np.float32)
        ok &= bool(np.all((pub == down) | (pub == up)))
    return ok


def distri_world2_worker(rank, world, store_dir, seed, device_type):
    """One process of the world-2 check: LeNet on the one card over gloo,
    five runs (grad_sync f32 wire, the all-reduce path, the bf16 wire, and
    the bf16 wire with each planted fault of WIRE_FAULTS); pickles what
    each ends with to ``store_dir``."""
    import pickle
    import torch.distributed as dist
    from bigdl_tpu_torch.parallel import grad_sync
    if device_type == "cuda":
        torch.cuda.set_device(0)
    torch.use_deterministic_algorithms(True)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(store_dir, "store"), world),
        rank=rank, world_size=world)
    try:
        B, steps = DISTRI["world2_batch"], DISTRI["world2_steps"]
        data = mnist.synthetic_mnist(B * world * steps, seed=0)
        # does gloo itself take CUDA tensors for the bucket collectives?
        probe = {}
        for name, fn, n_out in (("reduce_scatter_tensor",
                                 dist.reduce_scatter_tensor, 2),
                                ("all_gather_into_tensor",
                                 dist.all_gather_into_tensor, 8)):
            try:
                fn(torch.empty(n_out, device=device_type),
                   torch.ones(4, device=device_type))
                probe[name] = "accepted"
            except RuntimeError as e:
                probe[name] = f"refused: {str(e).splitlines()[0][:120]}"
        results = {"gloo_cuda": probe}
        for name, wire, kw in (
                ("f32", "f32", {}),
                ("plain", "f32", {"parameter_sharding": False}),
                ("bf16", "bf16", {}),
                ("no_update", "bf16", {}), ("stale_gather", "bf16", {})):
            model = lenet5(10).initialize(seed + 1)
            init = {k: v.detach().cpu().numpy().copy()
                    for k, v in model.named_parameters()}
            maxpool.reset_counts()
            opt = distri_optimizer(
                model, lenet_pipeline(data, True, batch=B, distributed=True),
                device_type, wire, 4, steps, lenet_sgd(), backend="gloo",
                **kw)
            with planted_wire_fault(name if name in WIRE_FAULTS else None):
                opt.optimize()
            params = dict(model.named_parameters())
            r = {"losses": opt.losses,
                 "launches": lenet_b1_launches(f"world 2, {name}"),
                 "init": init,
                 "params": {k: v.detach().numpy().copy()
                            for k, v in params.items()},
                 "backend": opt.mesh.backend, "world": opt._world,
                 "device": str(opt._run_device)}
            if opt._use_grad_sync:
                r["masters"] = [m.cpu().numpy()
                                for m in opt._final_opt_state["master"]]
                r["flat"] = [b.numpy() for b in grad_sync.flatten_to_buckets(
                    opt._gs_plan, [params[n].detach()
                                   for n in opt._gs_names])]
                full = grad_sync.gather_state(
                    opt._gs_plan, opt._final_opt_state)["master"]
                r["full_masters"] = [m.cpu().numpy() for m in full]
                r["master_params"] = {
                    n: v.cpu().numpy() for n, v in zip(
                        opt._gs_names,
                        grad_sync.unflatten_from_buckets(opt._gs_plan, full))}
            results[name] = r
        with open(os.path.join(store_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def distri_world2_phase(seed, device, card, report):
    """Two processes on the one card over gloo, CUDA compute, LeNet at batch
    64 a process (global 128), 8 steps in K=4 blocks.  First B1 against its
    plain version, bitwise, at the two pools' shapes at that batch; then:
    the grad_sync f32 wire must equal the all-reduce path bit for bit on
    both ranks, the ranks must agree, each rank's f32 master slices must
    reassemble into the published weights exactly, the bf16 wire's masters
    must stay within WIRE_DRIFT_LIMIT of the f32 wire's weights and its
    published weights must each be one of the two bf16 values around their
    master, each planted fault of WIRE_FAULTS must fail one of those two,
    and B1 must launch 2 a step."""
    import pickle
    gen = torch.Generator(device=device).manual_seed(1618)
    for name in DISTRI_POOL_CASES:
        pool_case_check(next(c for c in POOL_CASES if c[0] == name), gen,
                        device)
    world, steps = DISTRI["world2"], DISTRI["world2_steps"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        torch.multiprocessing.spawn(distri_world2_worker,
                                    args=(world, tmp, seed, device.type),
                                    nprocs=world,
                                    join=True)
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    wall = time.monotonic() - t0
    r0 = ranks[0]
    checks = {}
    checks["f32_equals_all_reduce"] = all(
        r["f32"]["losses"] == r["plain"]["losses"] and all(
            np.array_equal(r["f32"]["params"][k], r["plain"]["params"][k])
            for k in r["f32"]["params"]) for r in ranks)
    checks["ranks_agree"] = all(
        r["f32"]["losses"] == r0["f32"]["losses"] and all(
            np.array_equal(r["f32"]["params"][k], r0["f32"]["params"][k])
            for k in r0["f32"]["params"]) for r in ranks)
    checks["masters_reassemble"] = all(
        np.array_equal(np.concatenate([r["f32"]["masters"][b]
                                       for r in ranks]), flat)
        for b, flat in enumerate(r0["f32"]["flat"]))
    l32, l16 = np.array(r0["f32"]["losses"]), np.array(r0["bf16"]["losses"])
    drift = {n: wire_drift(r0[n]["master_params"], r0["f32"]["params"],
                           r0["f32"]["init"])
             for n in ("bf16",) + WIRE_FAULTS}
    rounded = {n: all(bf16_neighbours(r[n]) for r in ranks)
               for n in ("bf16",) + WIRE_FAULTS}
    checks["bf16_tracks_f32"] = bool(np.all(np.isfinite(l16))
                                     and drift["bf16"] <= WIRE_DRIFT_LIMIT)
    checks["bf16_publishes_masters_rounded"] = rounded["bf16"]
    # each planted fault fails one of the two checks above
    checks["no_update_caught"] = drift["no_update"] > WIRE_DRIFT_LIMIT
    checks["stale_gather_caught"] = not rounded["stale_gather"]
    checks["b1_two_a_step"] = all(r[n]["launches"] == 2 * steps
                                  for r in ranks for n in ("f32", "plain",
                                                           "bf16"))
    checks["gloo_cuda_world2"] = all(
        (r[n]["backend"], r[n]["world"], r[n]["device"]) ==
        ("gloo", world, device.type) for r in ranks
        for n in ("f32", "bf16"))
    print(f"distri world 2 (gloo, two processes on one card, LeNet batch "
          f"{DISTRI['world2_batch']} a process, {steps} steps K=4): "
          + ", ".join(f"{k} {v}" for k, v in checks.items())
          + f"; masters' drift from the f32 wire (limit {WIRE_DRIFT_LIMIT}): "
          + ", ".join(f"{n} {v:.4g}" for n, v in drift.items())
          + "; published = masters rounded: "
          + ", ".join(f"{n} {v}" for n, v in rounded.items())
          + f"; bf16 wire's largest loss gap "
          f"{float(np.max(np.abs(l16 - l32))):.3e}; gloo on CUDA tensors "
          f"itself: "
          + ", ".join(f"{k} {v}" for k, v in r0["gloo_cuda"].items())
          + f"; f32 losses " + ", ".join(f"{v:.6f}" for v in l32)
          + f"; {wall:.1f} s [{card}]")
    report["distri_world2"] = {"checks": checks, "wire_drift": drift,
                               "rounded": rounded,
                               "gloo_cuda": r0["gloo_cuda"],
                               "f32_losses": l32.tolist(),
                               "bf16_losses": l16.tolist(), "wall_s": wall}
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"distri world-2 check failed: {failed}")


def distri_resume_run(ckpt, device, resume_from=None):
    train, _ = lenet_data()
    opt = distri_optimizer(lenet5(10).initialize(7),
                           lenet_pipeline(train, True,
                                          DISTRI["resume_images"]),
                           device, "f32", 4, DISTRI["resume_iters"],
                           lenet_sgd())
    opt.set_checkpoint(ckpt, optim.several_iteration(DISTRI["resume_every"]))
    if resume_from is not None and not opt.resume(resume_from):
        raise AssertionError(f"no snapshot at {resume_from}")
    start = opt.state["neval"]
    opt.optimize()
    return opt, start


def distri_resume_phase(device, card, report):
    """The grad_sync state's snapshot and resume at world 1 (LeNet, K=4,
    under torch.use_deterministic_algorithms): a fresh optimizer resumed
    from the uninterrupted run's snapshot at iteration 4 must end where
    that run ends, losses and weights bit for bit; the snapshot holds the
    reference's {"master": [...], "opt": {"velocity": [...]}} layout."""
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ref, _ = distri_resume_run(os.path.join(tmp, "ref"), device)
            snap = os.path.join(tmp, "ref", "model.4")
            blob = load_snapshot(snap)
            layout = (set(blob["opt_state"]) == {"master", "opt"}
                      and set(blob["opt_state"]["opt"]) == {"velocity"}
                      and blob["manifest"]["schema"]["grad_sync"]["enabled"])
            res, start = distri_resume_run(os.path.join(tmp, "res"), device,
                                           resume_from=snap)
    finally:
        torch.use_deterministic_algorithms(False)
    same = ref.losses[start:] == res.losses and \
        params_equal(ref.model, res.model)
    print(f"lenet distri resume (world 1, K=4): resumed from iteration "
          f"{start} to {res.state['neval']}: grad_sync snapshot layout "
          f"{layout}, losses and weights bitwise {same} [{card}]")
    report["distri_resume"] = {"start": start, "bitwise": same,
                               "layout": layout}
    if not (same and layout and start == 4):
        raise AssertionError("the grad_sync snapshot did not resume "
                             "bit for bit")


def distri_phase(seed, device, card, report):
    """The slice-9 phases; returns B1's launches on the main path."""
    t0 = time.monotonic()
    launches = distri_resnet_phase(seed, device, card, report)
    print(f"phase distri-resnet: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    distri_vs_local_phase(seed, device, card, report)
    torch.cuda.empty_cache()
    print(f"phase distri-vs-local: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    distri_world2_phase(seed, device, card, report)
    print(f"phase distri-world2: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    distri_resume_phase(device, card, report)
    print(f"phase distri-resume: {time.monotonic() - t0:.1f} s")
    # the world-1 group the runs started
    torch.distributed.destroy_process_group()
    Engine.set_mesh(None)
    return launches


# ------------------------------------------------- CIFAR-10: VGG, ResNet-20
# The recipes of examples/vgg/train.py and examples/resnet/train_cifar10.py
# on synthetic CIFAR-10 (25,000 training images, half the real split's,
# cut for the script's time limit, and its 10,000 validation images):
# batch 128, normalize, pad-4 crop, flip and CHW through
# MTSampleToMiniBatch (8 workers), Top-1 over the validation
# images after every epoch.  HFlip turns two pairs of synthetic classes
# (0/3 and 4/7: the same square and channel, mirrored) into the same
# images, so Top-1 tops out near 0.8 on this data; "min_top1" is the bar.
# The per-sample pipeline holds a step to ~100 ms on the card's host
# (PERF.md section 5), ~20 s an epoch: VGG's LocalOptimizer run takes one
# epoch, ResNet-20's (which launches no kernel) and VGG's DistriOptimizer
# run the "steps" they name, Top-1 at their end; each profiles the block
# (one step, K=1) at "profile_at".
CIFAR = {"train": 25_000, "val": 10_000, "batch": 128, "workers": 8,
         "epochs": 1, "steps": {"resnet20": 150, "vgg_distri": 100},
         "warmup_steps": 20,
         "profile_at": {"vgg": 150, "resnet20": 60, "vgg_distri": 60},
         "check_K": 4, "min_top1": 0.5}
_CIFAR_DATA = {}


def cifar_data():
    """(training, validation) Samples of synthetic_cifar, made once."""
    if not _CIFAR_DATA:
        t0 = time.monotonic()
        _CIFAR_DATA["train"] = cifar.to_samples(
            *cifar.synthetic_cifar(CIFAR["train"]))
        _CIFAR_DATA["val"] = cifar.to_samples(
            *cifar.synthetic_cifar(CIFAR["val"], seed=9))
        print(f"cifar data: synthetic_cifar {CIFAR['train']} training and "
              f"{CIFAR['val']} validation images in "
              f"{time.monotonic() - t0:.1f} s")
    return _CIFAR_DATA["train"], _CIFAR_DATA["val"]


def cifar_augment():
    """The recipes' per-sample training augmentation: normalize, pad 4
    and crop 32, flip, HWC to CHW (each transform made once: it carries
    its random stream)."""
    train_aug = (image.BGRImgNormalizer(cifar.TRAIN_MEAN, cifar.TRAIN_STD),
                 image.RandomCropper(32, 32, pad=4), image.HFlip(),
                 image.ChannelOrder("CHW"))

    def augment(s):
        for t in train_aug:
            s = next(iter(t(iter([s]))))
        return s
    return augment


def cifar_train_set(samples, distributed=False):
    return (DataSet.array(samples, distributed=distributed)
            >> MTSampleToMiniBatch(CIFAR["batch"], cifar_augment(),
                                   workers=CIFAR["workers"]))


def cifar_val_set(samples):
    return (DataSet.array(samples)
            >> image.BGRImgNormalizer(cifar.TRAIN_MEAN, cifar.TRAIN_STD)
            >> image.ChannelOrder("CHW")
            >> SampleToMiniBatch(CIFAR["batch"], drop_remainder=False))


def cifar_sgd(name):
    """The recipe's SGD: ResNet-20's nesterov with MultiStep at epochs 80
    and 120, VGG's with EpochStep(25, 0.5)."""
    if name == "resnet20":
        return optim.SGD(0.1, momentum=0.9, dampening=0.0, nesterov=True,
                         weight_decay=1e-4,
                         learning_rate_schedule=optim.MultiStep(
                             [80, 120], 0.1, epoch_based=True))
    return optim.SGD(0.01, momentum=0.9, dampening=0.0, weight_decay=5e-4,
                     learning_rate_schedule=optim.EpochStep(25, 0.5))


def cifar_model(name, seed):
    model = resnet_cifar(20, class_num=10) if name == "resnet20" \
        else vgg_for_cifar10(10)
    return model.initialize(seed)


def cifar_run(name, seed, device, card, distributed=False):
    """One recipe run through LocalOptimizer or, ``distributed``, the
    DistriOptimizer the recipe's --distributed builds (over
    ``DataSet.array(..., distributed=True)``; world 1 over NCCL):
    CIFAR["epochs"] epochs, Top-1 over the validation images after every
    epoch, or the CIFAR["steps"] the run names, Top-1 at their end.
    Prints images/s and ms a step (host clock at replay, after the first
    CIFAR["warmup_steps"] steps, up to the first validation), peak
    memory, a profiled block and B1's launches; fails unless the loss
    falls, the last Top-1 passes CIFAR["min_top1"] and B1
    launched 5 times a VGG step (tiled_nchw) and never for ResNet-20."""
    key = name + ("_distri" if distributed else "")
    B, w = CIFAR["batch"], CIFAR["warmup_steps"]
    per_epoch = -(-CIFAR["train"] // B)
    steps = CIFAR["steps"].get(key, CIFAR["epochs"] * per_epoch)
    train, val = cifar_data()
    losses, clock, scores, prof = [], [], [], {}
    cls = optim.DistriOptimizer if distributed else LocalOptimizer

    class Recording(profiled_block(cls, CIFAR["profile_at"][key], card, 8,
                                   prof)):
        def _log_train_iteration(self, lr):
            losses.append(self.state["loss"])
            clock.append(time.perf_counter())

        def _run_validation(self, run):
            t = time.perf_counter()
            res = super()._run_validation(run)
            if res is not None:
                scores.append({"neval": self.state["neval"],
                               "top1": res["Top1Accuracy"].result,
                               "count": res["Top1Accuracy"].count,
                               "s": time.perf_counter() - t})
            return res

    opt = (Recording(cifar_model(name, seed),
                     cifar_train_set(train, distributed),
                     nn.ClassNLLCriterion(), device=device)
           .set_optim_method(cifar_sgd(name))
           .set_end_when(optim.max_iteration(steps))
           .set_validation(optim.several_iteration(steps)
                           if key in CIFAR["steps"] else optim.every_epoch(),
                           cifar_val_set(val),
                           [optim.Top1Accuracy()]))
    torch.cuda.reset_peak_memory_stats()
    maxpool.reset_counts()
    t1 = time.monotonic()
    opt.optimize()
    wall = time.monotonic() - t1
    peak = torch.cuda.max_memory_allocated()
    launches = maxpool.launches
    want = 5 * steps if name == "vgg" else 0
    if opt.state["neval"] != steps or launches != want \
            or maxpool.variant_launches["tiled_nchw"] != want:
        raise AssertionError(f"{key}: {opt.state['neval']} steps, B1 "
                             f"launched {launches} times "
                             f"({maxpool.variant_launches}); want {steps} "
                             f"steps and {want} tiled_nchw launches")
    if distributed and not (opt._world == 1 and opt._use_grad_sync and
                            opt.mesh.backend == ("nccl" if device.type ==
                                                 "cuda" else "gloo")):
        raise AssertionError(f"{key}: not the world-1 grad_sync path")
    end = min(steps, per_epoch) - 1
    step_s = (clock[end] - clock[w]) / (end - w)
    first, last = np.mean(losses[:w]), np.mean(losses[-w:])
    what = {"vgg": "VGG for CIFAR-10", "resnet20": "ResNet-20"}[name]
    route = "DistriOptimizer world 1 " + opt.mesh.backend if distributed \
        else "LocalOptimizer"
    kernel = (f"B1 launches {launches}, 5 a step, all tiled_nchw" if want
              else "no max pool, no kernel: B1 launches 0")
    print(f"train {what} {route} NCHW f32 batch {B}: {steps} steps, "
          f"{wall:.2f} s with validation; steps {w}..{end}: ms_per_step="
          f"{step_s * 1e3:.3f} images_per_s={B / step_s:.1f} "
          f"max_memory_allocated={peak}; mean loss of the first / last {w} "
          f"steps {first:.4f} / {last:.4f}; {kernel} [{card}]")
    for s in scores:
        print(f"{key} validation after iteration {s['neval']}: "
              f"Top1Accuracy={s['top1']:.4f} over {int(s['count'])} images "
              f"in {s['s'] * 1e3:.1f} ms [{card}]")
    print_profile(f"{key} step {CIFAR['profile_at'][key]} (batch {B}, f32)",
                  prof, card)
    if not scores or len(scores) != max(1, steps // per_epoch) \
            or scores[-1]["count"] != CIFAR["val"]:
        raise AssertionError(f"{key}: {len(scores)} validations in {steps} "
                             f"steps, the last over "
                             f"{scores[-1]['count'] if scores else 0} "
                             f"images")
    if not scores[-1]["top1"] > CIFAR["min_top1"]:
        raise AssertionError(f"{key}: Top-1 {scores[-1]['top1']:.4f} after "
                             f"{steps} steps, want > {CIFAR['min_top1']}")
    if not (np.all(np.isfinite(losses)) and last < first):
        raise AssertionError(f"{key}: the loss is not finite and falling "
                             f"({first} -> {last})")
    return {"steps": steps, "wall_s": wall, "ms_per_step": step_s * 1e3,
            "images_per_s": B / step_s, "max_memory_allocated": peak,
            "first_loss": first, "last_loss": last, "validations": scores,
            "launches": launches, "profile": prof}


def pool_cases_phase(names, seed, device, card, report, key):
    """B1 at the cases ``names`` of POOL_CASES: bitwise against its plain
    version on integer inputs (ties) in the variant TILED_CASES names,
    then :func:`pool_row` on post-ReLU inputs (time, bound, library)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = {}
    for name in names:
        case = pool_case(name)
        pool_case_check(case, gen, device)
        rows[name] = pool_row(case, gen, device, card)
        torch.cuda.empty_cache()
    report[key] = rows
    return rows


def cifar_distri_vs_local(seed, device, card, report):
    """VGG's world-1 DistriOptimizer (f32 wire) against LocalOptimizer
    over one K-step block of the recipe's pipeline from the same weights,
    under torch.use_deterministic_algorithms: losses and weights must be
    equal bit for bit."""
    K, B = CIFAR["check_K"], CIFAR["batch"]
    train, _ = cifar_data()
    init = cifar_model("vgg", seed + 1)

    def data():
        return DataSet.array(train[:K * B]) >> MTSampleToMiniBatch(
            B, cifar_augment(), workers=CIFAR["workers"])

    torch.use_deterministic_algorithms(True)
    try:
        local = copy.deepcopy(init)
        llosses = []
        lopt = (LocalOptimizer(local, data(), nn.ClassNLLCriterion(),
                               device=device)
                .set_optim_method(cifar_sgd("vgg")).set_steps_per_dispatch(K)
                .set_end_when(optim.max_iteration(K)))
        lopt._log_train_iteration = \
            lambda lr: llosses.append(lopt.state["loss"])
        lopt.optimize()
        dist_model = copy.deepcopy(init)
        dopt = distri_optimizer(dist_model, data(), device, "f32", K, K,
                                cifar_sgd("vgg"))
        dopt.optimize()
    finally:
        torch.use_deterministic_algorithms(False)
    same = llosses == dopt.losses and params_equal(local, dist_model)
    print(f"vgg distri world 1 vs LocalOptimizer, K={K} block of batch {B}: "
          f"losses and weights bitwise {same} (buckets "
          f"{dopt._gs_plan.num_buckets}); losses "
          + ", ".join(f"{v:.6f}" for v in dopt.losses) + f" [{card}]")
    report["cifar_distri_vs_local"] = {"bitwise": same,
                                       "losses": dopt.losses,
                                       "local_losses": llosses}
    if not same:
        raise AssertionError(f"VGG through DistriOptimizer at world 1 is "
                             f"not LocalOptimizer bit for bit: "
                             f"{dopt.losses} vs {llosses}")


def cifar_phase(seed, device, card, report):
    """The CIFAR-10 training phases; returns each run's results (B1's
    launches on the main path: ``["vgg"]["launches"]``)."""
    out = {}
    for name, distributed in (("vgg", False), ("resnet20", False),
                              ("vgg", True)):
        t0 = time.monotonic()
        key = name + ("_distri" if distributed else "")
        out[key] = cifar_run(name, seed, device, card, distributed)
        torch.cuda.empty_cache()
        print(f"phase cifar-{key}: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    cifar_distri_vs_local(seed, device, card, report)
    torch.cuda.empty_cache()
    print(f"phase cifar-distri-vs-local: {time.monotonic() - t0:.1f} s")
    # the world-1 group the runs started
    torch.distributed.destroy_process_group()
    Engine.set_mesh(None)
    report["cifar"] = out
    return out


# ------------------------------------------------------------ Inception v1
# bench.py's configuration of the BigDL whitepaper's model: NHWC, bf16
# compute, batch 256, 224x224, 1000 classes, with the recipe's SGD
# (examples/inception/train.py: lr 0.0898, momentum 0.9, dampening 0,
# weight decay 1e-4, Poly(0.5, 62000)) and augmentation, K=4.  The example's
# synthetic images, 1024 of them, each "repeat" times an epoch: 8 steps,
# two blocks an epoch, so one block in two ends an epoch and has the next
# block staged after it rather than beside it.  Each run times 8 steps
# (two blocks, one epoch's end among them; 16 steps over four blocks
# before the script's time limit asked for a cut).
INCEPTION = {"batch": 256, "K": 4, "size": 224, "classes": 1000,
             "samples": 1024, "repeat": 2, "workers": 8, "timed_blocks": 1,
             "check_batch": 4, "check_K": 4,
             # the check's LRN: an even size (where torch's window differs
             # from the reference's) and alpha 1 (the model's 1e-4 leaves
             # LRN within 1e-3 of the identity, blind to its window)
             "check_lrn": (4, 1.0, 0.75, 1.0)}
# the card against the CPU, step by step: each step's loss and each
# parameter's gradient (||g_card - g_cpu|| / ||g_cpu||), from the card's own
# weights of that step; above the sound readings, below the two planted
# faults that every run measures and requires to exceed it
INCEPTION_TRAIN_TOL = 5e-2
_INCEPTION_DATA = {}


def synthetic_imagenet(n, size=224, classes=1000, seed=0):
    """The Inception example's synthetic stand-in: a class-coloured 56x56
    patch on noise, uint8 HWC."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, n).astype(np.int32)
    imgs = rng.integers(0, 60, (n, size, size, 3)).astype(np.float32)
    for i, y in enumerate(labels):
        r, c = divmod(int(y) % 16, 4)
        imgs[i, r * 56:(r + 1) * 56, c * 56:(c + 1) * 56, int(y) % 3] += 150
    return imgs.astype(np.uint8), labels


def inception_augment(size, to_chw=False):
    """The recipe's per-sample augmentation (HWC for the NHWC model)."""
    aug = (V.RandomAlterAspect(target_size=size) >> V.HFlip()
           >> V.ChannelNormalize((123.0, 117.0, 104.0), (58.4, 57.1, 57.4))
           >> V.ImageFrameToSample(to_chw=to_chw))
    return lambda s: aug(V.ImageFeature(s.feature, s.label))["sample"]


def inception_data():
    """(samples, their pre-augmented NHWC Samples), made once."""
    if not _INCEPTION_DATA:
        B, size = INCEPTION["batch"], INCEPTION["size"]
        t0 = time.monotonic()
        samples = cifar.to_samples(*synthetic_imagenet(
            INCEPTION["samples"], size, INCEPTION["classes"]))
        it = (DataSet.array(samples) >> MTSampleToMiniBatch(
            B, inception_augment(size), workers=INCEPTION["workers"])).data(
                train=False)
        augmented = [Sample(f, t) for b in it
                     for f, t in zip(b.input, b.target)]
        _INCEPTION_DATA["samples"] = samples
        _INCEPTION_DATA["augmented"] = augmented
        print(f"inception data: {len(samples)} synthetic images, "
              f"pre-augmented in {time.monotonic() - t0:.1f} s (8 workers)")
    return _INCEPTION_DATA["samples"], _INCEPTION_DATA["augmented"]


def inception_sgd(cls=optim.SGD):
    return cls(learning_rate=0.0898, momentum=0.9, dampening=0.0,
               weight_decay=1e-4,
               learning_rate_schedule=optim.Poly(0.5, 62000))


def profiled_block(cls, at, card, top, out):
    """``cls`` (an optimizer) whose block ``at`` (0-based) runs under
    torch.profiler, from its enqueue to the next block's: that block's
    device work, the next block's staging (the data pipeline's wait) and
    the replay of the block before.  ``out`` gets wall ms, device busy ms,
    the idle share and the top kernels and aten operations."""
    from torch.profiler import ProfilerActivity, profile

    class Profiled(cls):
        def _block(self, step_fn, staged, lrs, first_step):
            n = self._blocks_seen = getattr(self, "_blocks_seen", -1) + 1
            if n == at + 1:
                torch.cuda.synchronize()
                wall_ms = (time.monotonic() - self._prof_t0) * 1e3
                self._prof.__exit__(None, None, None)
                busy_ms, kernels, ops = device_time(self._prof)
                out.update(wall_ms=wall_ms, device_busy_ms=busy_ms,
                           idle_share=max(0.0, 1 - busy_ms / wall_ms)
                           if busy_ms else None,
                           kernel_launches=sum(c for _, _, c in kernels),
                           kernels=[list(k) for k in kernels[:top]],
                           ops=[list(o) for o in ops[:top]],
                           steps=len(staged.sizes))
            if n == at:
                torch.cuda.synchronize()
                self._prof = profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA])
                self._prof.__enter__()
                self._prof_t0 = time.monotonic()
            return super()._block(step_fn, staged, lrs, first_step)
    return Profiled


def inception_timed_phase(seed, device, card, report):
    """Inception v1 on the card, timed twice: over batches augmented
    beforehand and through the recipe's own pipeline (MTSampleToMiniBatch,
    8 workers).  Each run: a warm-up K=4 block, the timed blocks (images/s
    and ms a step from the host clock at each block's replay), a profiled
    block (idle share, top device kernels and operations) and a closing
    block; block losses that must be finite and fall, peak memory, B1's
    launches (13 a step, all bf16, all tiled_nhwc).  Returns B1's launches
    in the pre-augmented run."""
    B, K, size = INCEPTION["batch"], INCEPTION["K"], INCEPTION["size"]
    samples, augmented = inception_data()
    r = INCEPTION["repeat"]
    init = inception_v1(INCEPTION["classes"], format="NHWC").initialize(seed)
    datasets = {
        "pre_augmented": lambda: DataSet.array(augmented * r)
        >> SampleToMiniBatch(B),
        "pipeline": lambda: DataSet.array(samples * r)
        >> MTSampleToMiniBatch(B, inception_augment(size),
                               workers=INCEPTION["workers"])}
    out, launches = {}, {}
    sound_launch = maxpool.launch
    timed = INCEPTION["timed_blocks"]
    for name, make in datasets.items():
        t0 = time.monotonic()
        # the warm-up block, the timed ones, one whose replay waits on the
        # profiled block's enqueue (kept out of the timing), the profiled
        # block and the one that closes its window
        steps = K * (timed + 4)
        losses, clock, prof = [], [], {}

        class Recording(profiled_block(LocalOptimizer, timed + 2, card, 10,
                                       prof)):
            def _log_train_iteration(self, lr):
                losses.append(self.state["loss"])
                clock.append(time.perf_counter())

        opt = (Recording(copy.deepcopy(init), make(), nn.ClassNLLCriterion(),
                         device=device)
               .set_optim_method(inception_sgd())
               .set_compute_dtype(torch.bfloat16).set_steps_per_dispatch(K)
               .set_end_when(optim.max_iteration(steps)))
        torch.cuda.reset_peak_memory_stats()
        maxpool.reset_counts()
        dtypes = []  # of every B1 launch: the activations are bf16

        def launch(x, *a):
            dtypes.append(x.dtype)
            return sound_launch(x, *a)
        maxpool.launch = launch
        try:
            opt.optimize()
        finally:
            maxpool.launch = sound_launch
        launches[name] = maxpool.launches
        peak = torch.cuda.max_memory_allocated()
        if opt.state["neval"] != steps or launches[name] != 13 * steps \
                or maxpool.variant_launches["tiled_nhwc"] != 13 * steps:
            raise AssertionError(f"inception {name}: B1 launched "
                                 f"{launches[name]} times "
                                 f"({maxpool.variant_launches}) in "
                                 f"{opt.state['neval']} steps; want 13 "
                                 f"tiled_nhwc a step")
        if set(dtypes) != {torch.bfloat16}:
            raise AssertionError(f"inception {name}: B1 ran on "
                                 f"{set(dtypes)}, not on bf16")
        blocks = [float(np.mean(losses[i:i + K]))
                  for i in range(0, steps, K)]
        if not (np.all(np.isfinite(losses)) and blocks[-1] < blocks[0]):
            raise AssertionError(f"inception {name}: the loss is not finite "
                                 f"and falling: {blocks}")
        # block b's losses come back after block b+1 is enqueued: the
        # clock at the last step of each block marks that block's end
        ends = [clock[i + K - 1] for i in range(0, K * (timed + 1), K)]
        step_s = (ends[-1] - ends[0]) / (K * timed)
        out[name] = {"ms_per_step": step_s * 1e3,
                     "images_per_s": B / step_s, "block_losses": blocks,
                     "losses": losses, "max_memory_allocated": peak,
                     "launches": launches[name], "profile": prof,
                     "wall_s": time.monotonic() - t0}
        print(f"train inception_v1 {name} NHWC bf16 batch {B} K={K}: "
              f"{steps} steps, the {timed} timed blocks after the first: "
              f"ms_per_step={step_s * 1e3:.2f} images_per_s="
              f"{B / step_s:.1f} max_memory_allocated={peak} block losses "
              + ", ".join(f"{v:.4f}" for v in blocks)
              + f"; B1 launches {launches[name]} for {steps} steps, 13 a "
              f"step, all bf16 tiled_nhwc; run {time.monotonic() - t0:.1f} "
              f"s [{card}]")
        print_profile(f"inception_v1 {name} block {timed + 2} ({K} steps "
                      f"of batch {B}, bf16)", prof, card)
        del opt
        torch.cuda.empty_cache()
    report["inception_train"] = out
    return launches["pre_augmented"]


def inception_check_model(seed):
    """The check's Inception v1: NCHW f32, the LRNs at INCEPTION["check_lrn"]
    and dropout off (its mask comes from the card's generator, which the
    CPU cannot redraw)."""
    model = inception_v1(INCEPTION["classes"]).initialize(seed)
    size, alpha, beta, k = INCEPTION["check_lrn"]
    for m in model.modules():
        if isinstance(m, nn.SpatialCrossMapLRN):
            m.size, m.alpha, m.beta, m.k = size, alpha, beta, k
        if isinstance(m, nn.Dropout):
            m.p = 0.0
    return model


def inception_cpu_step(init, params, batch):
    """The loss and the gradients of one check step on the CPU (the plain
    versions), from ``params`` on ``batch``."""
    m = copy.deepcopy(init)
    with torch.no_grad():
        for k, p in m.named_parameters():
            p.copy_(params[k])
            p.requires_grad_(True)
    loss = nn.ClassNLLCriterion().apply(m(torch.from_numpy(batch.input)),
                                        torch.from_numpy(batch.target))
    loss.backward()
    return loss.item(), {k: p.grad.double() for k, p in m.named_parameters()}


@contextlib.contextmanager
def planted_inception_fault(kind):
    """A fault of the card run: ``"lrn_torch_window"`` (the LRNs through
    ``torch.nn.functional.local_response_norm``, whose even window sits
    one channel lower than the reference's) or ``"concat_towers_swapped"``
    (module 4a concatenates its 3x3 and 5x5 towers the other way round);
    None: sound."""
    sound = {nn.SpatialCrossMapLRN: nn.SpatialCrossMapLRN.forward,
             nn.Concat: nn.Concat.forward}
    if kind == "lrn_torch_window":
        nn.SpatialCrossMapLRN.forward = \
            lambda self, x: torch.nn.functional.local_response_norm(
                x, self.size, self.alpha, self.beta, self.k)
    elif kind == "concat_towers_swapped":
        def forward(self, x):
            outs = [m(x) for m in self._modules.values()]
            if self.name == "4a":
                outs[1], outs[2] = outs[2], outs[1]
            return torch.cat(outs, self.dim)
        nn.Concat.forward = forward
    elif kind is not None:
        raise ValueError(f"unknown planted fault {kind!r}")
    try:
        yield
    finally:
        for cls, fn in sound.items():
            cls.forward = fn


def inception_check_phase(seed, device, card, report):
    """Inception v1 in NCHW f32 at batch INCEPTION["check_batch"] through
    one K=4 LocalOptimizer block on the card (B1 tiled_nchw, 13 launches a
    step) against the CPU, step by step (:func:`wd_step_reading` with
    :func:`norm_share`), with
    the recipe's SGD; the two planted faults of
    :func:`planted_inception_fault` must read above INCEPTION_TRAIN_TOL."""
    K, B = INCEPTION["check_K"], INCEPTION["check_batch"]
    samples, _ = inception_data()
    it = (DataSet.array(samples[:K * B]) >> MTSampleToMiniBatch(
        B, inception_augment(INCEPTION["size"], to_chw=True),
        workers=INCEPTION["workers"])).data(train=False)
    batches = list(it)
    flat = [Sample(f, t) for b in batches for f, t in zip(b.input, b.target)]
    init = inception_check_model(seed + 1)

    def card_run(fault=None):
        sgd = inception_sgd(recording(optim.SGD))
        losses = []
        opt = (LocalOptimizer(copy.deepcopy(init),
                              DataSet.array(flat) >> SampleToMiniBatch(B),
                              nn.ClassNLLCriterion(), device=device)
               .set_optim_method(sgd).set_steps_per_dispatch(K)
               .set_end_when(optim.max_iteration(K)))
        opt._log_train_iteration = lambda lr: losses.append(opt.state["loss"])
        with planted_inception_fault(fault):
            opt.optimize()
        return losses, sgd.steps

    maxpool.reset_counts()
    card_losses, card_steps = card_run()
    launches = maxpool.launches
    if launches != 13 * K or \
            maxpool.variant_launches["tiled_nchw"] != 13 * K:
        raise AssertionError(f"B1 launched {launches} times "
                             f"({maxpool.variant_launches}) in {K} NCHW "
                             f"steps (want 13 tiled_nchw a step)")
    sound, worst = wd_step_reading(card_losses, card_steps, init, batches,
                                   inception_cpu_step, norm_share)
    faults, fault_worst = {}, {}
    for fault in ("lrn_torch_window", "concat_towers_swapped"):
        faults[fault], fault_worst[fault] = wd_step_reading(
            *card_run(fault), init, batches, inception_cpu_step, norm_share)
    print(f"inception train-vs-cpu largest shares (share, what): sound "
          f"{worst}; " + "; ".join(f"{k} {v}" for k, v in fault_worst.items()))
    print(f"inception train-vs-cpu check, NCHW f32, {K} steps of batch {B} "
          f"step by step: sound {sound:.3e}, planted faults "
          + ", ".join(f"{k} {v:.3e}" for k, v in faults.items())
          + f" (tol {INCEPTION_TRAIN_TOL}); card losses "
          + ", ".join(f"{v:.6f}" for v in card_losses) + f" [{card}]")
    report["inception_check"] = {"sound": sound, "largest": worst,
                                 "planted_faults": faults,
                                 "planted_largest": fault_worst,
                                 "tol": INCEPTION_TRAIN_TOL,
                                 "card_losses": card_losses,
                                 "launches": launches}
    if not sound <= INCEPTION_TRAIN_TOL:
        raise AssertionError(f"Inception v1 on the card is {sound:.3e} from "
                             f"the CPU, over the limit {INCEPTION_TRAIN_TOL}")
    for fault, err in faults.items():
        if not err > INCEPTION_TRAIN_TOL:
            raise AssertionError(
                f"planted fault {fault} reads {err:.3e}, inside the "
                f"Inception tolerance {INCEPTION_TRAIN_TOL}: the check is "
                f"blind")


def inception_phase(seed, device, card, report):
    """The Inception v1 training phases; returns B1's launches on the main
    path (the pre-augmented timed run)."""
    t0 = time.monotonic()
    launches = inception_timed_phase(seed, device, card, report)
    torch.cuda.empty_cache()
    print(f"phase inception-timed: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    inception_check_phase(seed, device, card, report)
    torch.cuda.empty_cache()
    print(f"phase inception-vs-cpu: {time.monotonic() - t0:.1f} s")
    return launches


# ------------------------------------------- autoencoder, every optim method
AE = {"train": 60_000, "batch": 128, "epochs": 5, "lr": 0.01,
      "bottleneck": 32, "recon": 256, "check_K": 4, "profile_at": 2}
# a method's K=4 block on the card against the CPU, step by step
# (ae_step_reading: each step's loss, gradients, update and state, each as
# a norm share): above the sound readings, below the planted faults that
# every run measures
AE_STEP_TOL = 1e-4
# the methods the phase drives (name, constructor, whether elementwise)
AE_METHODS = {
    "sgd_bf16_velocity": lambda: optim.SGD(0.1, momentum=0.9,
                                           state_dtype=torch.bfloat16),
    "parallel_adam": lambda: optim.ParallelAdam(0.001),
    "adagrad": lambda: optim.Adagrad(AE["lr"]),
    "adadelta": lambda: optim.Adadelta(),
    "adamax": lambda: optim.Adamax(),
    "rmsprop": lambda: optim.RMSprop(0.001),
    "ftrl": lambda: optim.Ftrl(0.05),
    "lbfgs": lambda: optim.LBFGS(0.1, history=5),
}
_AE_DATA = {}


def ae_data():
    """The recipe's images: synthetic MNIST at MNIST's count, scaled to
    [0, 1] (float32 (n, 28, 28)); made once."""
    if not _AE_DATA:
        imgs, _ = mnist.synthetic_mnist(AE["train"], seed=0)
        _AE_DATA["x"] = imgs.astype(np.float32) / 255.0
    return _AE_DATA["x"]


def ae_dataset(x):
    """The recipe's dataset: each image its own target, flattened."""
    return DataSet.array([Sample(a, a.reshape(-1)) for a in x]) \
        >> SampleToMiniBatch(AE["batch"])


def ae_model(seed, regularized=False):
    model = autoencoder(AE["bottleneck"]).initialize(seed)
    if regularized:
        for i in (1, 3):
            model[i].w_regularizer = nn.L1L2Regularizer(1e-4, 1e-4)
            model[i].b_regularizer = nn.L1L2Regularizer(1e-4, 1e-4)
    return model


def ae_recipe_phase(seed, device, card, report):
    """``examples/autoencoder/train.py``'s recipe through LocalOptimizer on
    the card: 784 -> 32 -> 784, batch 128, Adagrad lr 0.01, MSE, five
    epochs of 60,000 images, K from ``Engine.steps_per_dispatch()``; ms a
    step and samples/s over epochs 2-5, one profiled block, each epoch's
    mean loss (must fall) and the reconstruction MSE of 256 images."""
    x = ae_data()
    B, epochs = AE["batch"], AE["epochs"]
    k = Engine.steps_per_dispatch(backend=device.type)
    # an epoch counts records: its last batch runs into the next pass
    per_epoch = -(-AE["train"] // B)
    losses, clock, prof = [], [], {}

    class Recording(LocalOptimizer):
        def _log_train_iteration(self, lr):
            losses.append(self.state["loss"])
            clock.append(time.perf_counter())

    model = ae_model(seed)
    cls = profiled_block(Recording, AE["profile_at"], card, 6, prof)
    opt = (cls(model, ae_dataset(x), nn.MSECriterion(), device=device)
           .set_optim_method(optim.Adagrad(AE["lr"]))
           .set_steps_per_dispatch(k)
           .set_end_when(optim.max_epoch(epochs)))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    opt.optimize()
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    steps = len(losses)
    if steps != epochs * per_epoch:
        raise AssertionError(f"autoencoder ran {steps} steps, want "
                             f"{epochs * per_epoch}")
    epoch_loss = [float(np.mean(losses[e * per_epoch:(e + 1) * per_epoch]))
                  for e in range(epochs)]
    step_s = (clock[-1] - clock[per_epoch - 1]) / (steps - per_epoch)
    with torch.no_grad():
        net = copy.deepcopy(model).to(device).eval()
        xs = torch.from_numpy(x[:AE["recon"]]).to(device)
        recon = net(xs)
        mse = float(((recon - xs.reshape(len(xs), -1)) ** 2).mean())
    print_profile(f"autoencoder block {AE['profile_at']} (K={k})", prof,
                  card, 6)
    print(f"train autoencoder 784-{AE['bottleneck']}-784 batch {B} K={k} "
          f"Adagrad lr {AE['lr']} MSE: {epochs} epochs of {AE['train']} "
          f"({steps} steps, {wall:.1f} s); epochs 2-{epochs}: "
          f"ms_per_step={step_s * 1e3:.3f} samples_per_s={B / step_s:.1f} "
          f"max_memory_allocated={peak}; epoch losses "
          + ", ".join(f"{v:.6f}" for v in epoch_loss)
          + f"; reconstruction MSE of {AE['recon']} images {mse:.6f} "
          f"[{card}]")
    report["autoencoder"] = {"k": k, "steps": steps, "wall_s": wall,
                             "ms_per_step": step_s * 1e3,
                             "samples_per_s": B / step_s,
                             "max_memory_allocated": peak,
                             "epoch_losses": epoch_loss, "recon_mse": mse,
                             "profile": prof}
    if not (np.all(np.isfinite(losses)) and epoch_loss[-1] < epoch_loss[0]):
        raise AssertionError(f"the autoencoder's loss does not fall: "
                             f"{epoch_loss}")


def host_tree(tree):
    """A CPU copy of an optimizer state (dicts, lists, tensors)."""
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_tree(v) for v in tree)
    return tree.detach().to("cpu", copy=True)


def tree_pairs(a, b, prefix=""):
    """(path, leaf of a, leaf of b) over two trees of one structure."""
    if isinstance(a, dict):
        for k in a:
            yield from tree_pairs(a[k], b[k], f"{prefix}{k}.")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from tree_pairs(x, y, f"{prefix}{i}.")
    else:
        yield prefix[:-1], a, b


def state_recording(make):
    """An optimization method (``make()``'s class) that keeps a CPU copy
    of every step's parameters, gradients and state before its update, and
    of the parameters and state after it, in ``steps``."""
    base = make()

    class Rec(type(base)):
        def update(self, grads, params, state, lr, step):
            before = (host_tree(params), host_tree(grads), host_tree(state))
            super().update(grads, params, state, lr, step)
            self.steps.append(before + (host_tree(params), host_tree(state),
                                        lr, step))
    rec = copy.copy(base)
    rec.__class__ = Rec
    rec.steps = []
    return rec


class AdagradEpsInSqrt(optim.Adagrad):
    """Planted fault: ``epsilon`` inside the square root."""

    @torch.no_grad()
    def update(self, grads, params, state, lr, step):
        for k in params:
            g, a = grads[k], state["accum"][k]
            a.copy_(a + g * g)
            params[k].sub_(lr * g / torch.sqrt(a + self.epsilon))


class AdadeltaSwapped(optim.Adadelta):
    """Planted fault: the two accumulators swapped in the step."""

    @torch.no_grad()
    def update(self, grads, params, state, lr, step):
        rho, eps = self.rho, self.epsilon
        for k in params:
            g, a, au = grads[k], state["accum"][k], state["accum_update"][k]
            a.copy_(rho * a + (1 - rho) * g * g)
            delta = g * torch.sqrt(a + eps) / torch.sqrt(au + eps)
            au.copy_(rho * au + (1 - rho) * delta * delta)
            params[k].sub_(lr * delta)


AE_FAULTS = {"adagrad_eps_in_sqrt": ("adagrad", AdagradEpsInSqrt),
             "adadelta_accumulators_swapped": ("adadelta", AdadeltaSwapped)}


def ae_step_reading(init, steps, batches, make, losses):
    """How far a block on the card is from the CPU, step by step: for each
    step j, the CPU redoes the forward and backward from the card's
    weights of step j on batch j (the loss against the card's, relative;
    each gradient by its norm share), then the update with ``make()`` from
    the card's gradients, weights and state of step j (the update, each
    weight's change, and every state leaf against the card's, by norm
    share).  (reading, its four largest (share, what))."""
    rows = []
    for j, (p, g, st, p_after, st_after, lr, step) in enumerate(steps):
        m = copy.deepcopy(init)
        with torch.no_grad():
            for k, t in m.named_parameters():
                t.copy_(p[k])
                t.requires_grad_(True)
        x = torch.from_numpy(batches[j].input)
        y = torch.from_numpy(batches[j].target)
        loss = nn.MSECriterion().apply(m(x), y) + nn.regularization_loss(m)
        loss.backward()
        rows.append((abs(losses[j] - loss.item()) / abs(loss.item()),
                     f"step {j} loss"))
        rows += [(norm_share(g[k].double(), t.grad.double()),
                  f"step {j} grad {k}") for k, t in m.named_parameters()]
        cp, cst = copy.deepcopy(p), copy.deepcopy(st)
        make().update({k: v.clone() for k, v in g.items()}, cp, cst, lr,
                      step)
        rows += [(norm_share((p_after[k] - p[k]).double(),
                             (cp[k] - p[k]).double()), f"step {j} update {k}")
                 for k in p]
        rows += [(norm_share(a.double(), b.double()), f"step {j} state {k}")
                 for k, a, b in tree_pairs(st_after, cst)
                 if a.is_floating_point()]
        rows += [(float(not torch.equal(a, b)), f"step {j} state {k}")
                 for k, a, b in tree_pairs(st_after, cst)
                 if not a.is_floating_point()]
    rows.sort(key=lambda r: -r[0])
    return rows[0][0], rows[:4]


def ae_block(model, method, x, device, k, distributed=False, **kw):
    """One K-step block of the recipe through LocalOptimizer (or a world-1
    DistriOptimizer): (per-step losses, optimizer)."""
    losses = []
    if distributed:
        opt = optim.Optimizer.create(model, ae_dataset(x), nn.MSECriterion(),
                                     distributed=True, device=device, **kw)
    else:
        opt = LocalOptimizer(model, ae_dataset(x), nn.MSECriterion(),
                             device=device)
    opt = (opt.set_optim_method(method).set_steps_per_dispatch(k)
           .set_end_when(optim.max_iteration(k)))
    opt._log_train_iteration = lambda lr: losses.append(opt.state["loss"])
    opt.optimize()
    return losses, opt


def ae_methods_phase(seed, device, card, report):
    """Every optim method (and Adagrad with an L1L2 regularizer on both
    Linears) through one K=4 block of the recipe on the card against the
    CPU (:func:`ae_step_reading`), two planted faults above the limit;
    LBFGS's update on the card with host syncs made errors; then each
    elementwise method through a world-1 DistriOptimizer over NCCL,
    bitwise equal to LocalOptimizer, and LBFGS refused by the ZeRO-1 path
    and bitwise on ``parameter_sharding=False``."""
    K, B = AE["check_K"], AE["batch"]
    x = ae_data()[:K * B]
    # the batches the optimizer's first K steps read (its stream wraps)
    batches = list(itertools.islice(ae_dataset(x).data(train=True), K))
    runs = {name: (make, False) for name, make in AE_METHODS.items()}
    runs["adagrad_l1l2"] = (AE_METHODS["adagrad"], True)
    readings, largest, faults = {}, {}, {}
    for name, (make, reg) in runs.items():
        init = ae_model(seed + 1, reg)
        rec = state_recording(make)
        losses, _ = ae_block(copy.deepcopy(init), rec, x, device, K)
        readings[name], largest[name] = ae_step_reading(
            init, rec.steps, batches, make, losses)
    for fault, (sound, cls) in AE_FAULTS.items():
        init = ae_model(seed + 1)
        base = AE_METHODS[sound]()
        planted = lambda: cls(**({"learning_rate": base.learning_rate}  # noqa: E731
                                 if sound == "adagrad" else {}))
        rec = state_recording(planted)
        losses, _ = ae_block(copy.deepcopy(init), rec, x, device, K)
        faults[fault], largest[fault] = ae_step_reading(
            init, rec.steps, batches, AE_METHODS[sound], losses)
    # LBFGS's in-loop update reads nothing back: every host sync an error
    lb = optim.LBFGS(0.1, history=3)
    params = {k: v.detach().to(device) for k, v in
              ae_model(seed).named_parameters()}
    lst = lb.init_state(params)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for step in range(4):  # a convex quadratic's gradients
            lb.update({k: (p - 0.5) * 0.1 for k, p in params.items()},
                      params, lst, 0.1, step)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    pairs = int(lst["pairs"])
    print("autoencoder methods card-vs-cpu largest shares (share, what): "
          + "; ".join(f"{k} {v}" for k, v in largest.items()))
    print(f"autoencoder methods card-vs-cpu, K={K} block of batch {B} step "
          f"by step: " + ", ".join(f"{k} {v:.3e}"
                                   for k, v in readings.items())
          + "; planted faults " + ", ".join(f"{k} {v:.3e}"
                                            for k, v in faults.items())
          + f" (tol {AE_STEP_TOL}); LBFGS update under sync debug mode "
          f"'error': 4 steps, {pairs} pairs pushed [{card}]")
    # world 1: DistriOptimizer against LocalOptimizer, bit for bit
    bitwise = {}
    torch.use_deterministic_algorithms(True)
    try:
        for name, make in AE_METHODS.items():
            init = ae_model(seed + 2)
            local, dist_model = copy.deepcopy(init), copy.deepcopy(init)
            llosses, _ = ae_block(local, make(), x, device, K)
            if name == "lbfgs":
                try:
                    ae_block(copy.deepcopy(init), make(), x, device, K,
                             distributed=True)
                except ValueError as e:
                    refused = str(e)
                else:
                    raise AssertionError("the ZeRO-1 path took LBFGS")
                if "grad_sync requires an elementwise optimizer" \
                        not in refused:
                    raise AssertionError(f"LBFGS refused with {refused!r}")
                dlosses, dopt = ae_block(dist_model, make(), x, device, K,
                                         distributed=True,
                                         parameter_sharding=False)
            else:
                dlosses, dopt = ae_block(dist_model, make(), x, device, K,
                                         distributed=True)
            bitwise[name] = llosses == dlosses \
                and params_equal(local, dist_model)
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"autoencoder DistriOptimizer world 1 (NCCL) vs LocalOptimizer, "
          f"K={K} block: bitwise " + ", ".join(
              f"{k} {v}" for k, v in bitwise.items())
          + f"; LBFGS refused by ZeRO-1: {refused[:80]}... [{card}]")
    report["autoencoder_methods"] = {
        "readings": readings, "largest": largest, "planted_faults": faults,
        "tol": AE_STEP_TOL, "lbfgs_pairs": pairs, "world1_bitwise": bitwise,
        "lbfgs_refused": refused}
    for name, v in readings.items():
        if not v <= AE_STEP_TOL:
            raise AssertionError(f"{name} on the card is {v:.3e} from the "
                                 f"CPU, over the limit {AE_STEP_TOL}")
    for name, v in faults.items():
        if not v > AE_STEP_TOL:
            raise AssertionError(f"planted fault {name} reads {v:.3e}, "
                                 f"inside the limit {AE_STEP_TOL}: the check "
                                 f"is blind")
    if not all(bitwise.values()):
        raise AssertionError(f"world-1 DistriOptimizer is not "
                             f"LocalOptimizer bit for bit: {bitwise}")


def autoencoder_phase(seed, device, card, report):
    t0 = time.monotonic()
    ae_recipe_phase(seed, device, card, report)
    print(f"phase autoencoder-recipe: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    ae_methods_phase(seed, device, card, report)
    print(f"phase autoencoder-methods: {time.monotonic() - t0:.1f} s")


# --------------------------------------- ResNet-50 rematerialization, B1
REMAT = {"check_batch": 32, "K": 4, "timed_blocks": 1}
REMAT_MODES = {  # name: (resnet50's remat, the activation-memory policy)
    "none": (False, None), "remat_true": (True, None),
    "remat_tails": ("tails", None), "policy_dots": (False, "dots"),
    "policy_full": (False, "full")}
REMAT_TIMED = ("none", "remat_true", "remat_tails", "policy_full")


def remat_run(init, mode, dataset, device, steps, k, compute, sgd,
              cls=LocalOptimizer):
    """ResNet-50 (``init`` rebuilt under ``mode``'s remat, same weights)
    through ``cls``: (per-step losses, replay clock, model, optimizer)."""
    remat, policy = REMAT_MODES[mode]
    model = resnet50(RESNET["classes"], format="NHWC", remat=remat)
    model.load_state_dict(init.state_dict())
    losses, clock = [], []

    class Recording(cls):
        def _log_train_iteration(self, lr):
            losses.append(self.state["loss"])
            clock.append(time.perf_counter())

    opt = (Recording(model, dataset, nn.ClassNLLCriterion(), device=device)
           .set_optim_method(sgd).set_compute_dtype(compute)
           .set_steps_per_dispatch(k)
           .set_end_when(optim.max_iteration(steps)))
    if policy is not None:
        opt.set_activation_memory(policy)
    opt.optimize()
    return losses, clock, model, opt


# the check's runs: (label, mode of REMAT_MODES, compute dtype, planted
# fault); each is held against "none" at its compute dtype
REMAT_CHECKS = ([(m, m, None, None) for m in REMAT_MODES]
                + [("fault_bn_twice", "remat_true", None, "bn_twice")]
                + [(m + "+bf16", m, torch.bfloat16, None)
                   for m in ("none", "remat_true", "remat_tails")]
                + [("fault_params_outside+bf16", "remat_true", torch.bfloat16,
                    "params_outside")])


def _remat_params_outside(self, x):
    """Planted fault: the block runs on its own f32 parameters, which do
    not enter the checkpoint, so under bf16 compute the recomputation
    misses the casts of the first forward."""
    return nn.module.checkpointed(self.inner, self.inner, self.policy)(x)


def remat_check_phase(seed, device, card, report):
    """Batch 32 under torch.use_deterministic_algorithms: one K=4 block in
    each run of ``REMAT_CHECKS`` (every mode at f32; no remat, remat=True
    and "tails" under bf16 compute, where the recomputation runs inside
    the mixed-precision functional_call); its losses, weights and
    BatchNorm statistics must equal remat=False's at its dtype bit for
    bit, B1 launch once a step in each, and two planted faults must break
    it: BatchNorm updating its statistics again in the recomputed forward
    (f32), and Remat keeping its block's parameters out of the checkpoint
    (bf16; this one may also raise where the recomputation meets the f32
    weights)."""
    K, B = REMAT["K"], REMAT["check_batch"]
    rng = np.random.default_rng(seed)
    xs = rng.normal(0, 1, (K * B, RESNET["size"], RESNET["size"], 3)) \
        .astype(np.float32)
    ys = rng.integers(0, RESNET["classes"], K * B)
    samples = [Sample(a, np.int32(b)) for a, b in zip(xs, ys)]
    init = resnet50(RESNET["classes"], format="NHWC").initialize(seed)
    out, runs = {}, {}
    torch.use_deterministic_algorithms(True)
    try:
        for label, mode, compute, fault in REMAT_CHECKS:
            sound = nn.layers.recomputing, nn.Remat.forward
            if fault == "bn_twice":
                nn.layers.recomputing = lambda: False
            elif fault == "params_outside":
                nn.Remat.forward = _remat_params_outside
            maxpool.reset_counts()
            try:
                losses, _, model, _ = remat_run(
                    init, mode, DataSet.array(samples) >> SampleToMiniBatch(B),
                    device, K, K, compute, optim.SGD(0.01, momentum=0.9))
                runs[label] = (compute, losses, model.state_dict(),
                               maxpool.launches, None)
                del model
            except RuntimeError as e:
                if fault is None:
                    raise
                runs[label] = (compute, None, None, maxpool.launches,
                               str(e).splitlines()[0])
            finally:
                nn.layers.recomputing, nn.Remat.forward = sound
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    base = {c: runs[label][1:3] for label, m, c, f in REMAT_CHECKS
            if m == "none"}
    for label, (compute, losses, state, launches, raised) in runs.items():
        want_losses, want_state = base[compute]
        dtype = "bf16" if compute is not None else "f32"
        if raised is not None:
            out[label] = {"bitwise": False, "raised": raised,
                          "launches": launches}
            print(f"resnet50 remat check {label}: {dtype} batch {B}, K={K}: "
                  f"raised {raised!r} [{card}]")
            continue
        same = losses == want_losses and all(
            torch.equal(state[k], v) for k, v in want_state.items())
        worst = max(((state[k].double() - v.double()).abs().max()
                     / v.double().abs().max().clamp(min=1e-30)).item()
                    for k, v in want_state.items())
        out[label] = {"bitwise": same, "largest": worst,
                      "launches": launches, "losses": losses}
        print(f"resnet50 remat check {label}: {dtype} batch {B}, K={K} block "
              f"under deterministic algorithms: losses, weights and BN "
              f"statistics bitwise to remat=False {same} (largest "
              f"difference {worst:.3e} of an array's largest); B1 launches "
              f"{launches}; losses " + ", ".join(f"{v:.6f}" for v in losses)
              + f" [{card}]")
    report["remat_check"] = out
    for label, row in out.items():
        if label.startswith("fault"):
            if row["bitwise"]:
                raise AssertionError(f"the planted fault {label} passed the "
                                     f"remat check: it is blind")
            continue
        if not row["bitwise"]:
            raise AssertionError(f"resnet50 {label} is not remat=False bit "
                                 f"for bit (largest {row['largest']:.3e})")
        if row["launches"] != K:
            raise AssertionError(f"{label}: B1 launched {row['launches']} "
                                 f"times in {K} steps")


def remat_timed_phase(seed, device, card, report):
    """``bench.py``'s ResNet-50 configuration (NHWC, bf16, batch 256, the
    recipe's SGD, 1,024 pre-augmented images) in each mode of
    ``REMAT_TIMED``: a warm-up block and one timed K=4 block (ms a step,
    images/s, peak memory, B1's launches: one a step), then a second run
    of two steps whose first runs under torch.profiler (its device time
    and idle share; kept apart, as reading the trace takes the host
    seconds).  Returns B1's launches in the timed runs by mode."""
    B, K = RESNET["batch"], REMAT["K"]
    steps = K * (1 + REMAT["timed_blocks"])
    per_epoch = RESNET["samples"] // B
    _, augmented = resnet_data()
    init = resnet50(RESNET["classes"], format="NHWC").initialize(seed)
    out, launches = {}, {}
    for mode in REMAT_TIMED:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        maxpool.reset_counts()
        t0 = time.monotonic()
        losses, clock, _, opt = remat_run(
            init, mode, DataSet.array(augmented) >> SampleToMiniBatch(B),
            device, steps, K, torch.bfloat16, recipe_sgd(per_epoch))
        peak = torch.cuda.max_memory_allocated()
        launches[mode] = maxpool.launches
        variants = dict(maxpool.variant_launches)
        del opt
        ends = [clock[i + K - 1] for i in range(0, steps, K)]
        step_s = (ends[-1] - ends[0]) / (steps - K)
        prof = {}
        remat_run(init, mode, DataSet.array(augmented) >> SampleToMiniBatch(B),
                  device, 2, 1, torch.bfloat16, recipe_sgd(per_epoch),
                  profiled_block(LocalOptimizer, 0, card, 6, prof))
        out[mode] = {"ms_per_step": step_s * 1e3, "images_per_s": B / step_s,
                     "max_memory_allocated": peak, "launches": launches[mode],
                     "losses": losses, "profile": prof,
                     "wall_s": time.monotonic() - t0}
        print_profile(f"resnet50 {mode} step", prof, card, 4)
        print(f"train resnet50 {mode} NHWC bf16 batch {B} K={K}: "
              f"{steps - K} timed steps: ms_per_step={step_s * 1e3:.2f} "
              f"images_per_s={B / step_s:.1f} max_memory_allocated={peak} "
              f"profiled step device_busy_ms="
              f"{prof.get('device_busy_ms', 0.0):.2f}; B1 launches "
              f"{launches[mode]} for {steps} steps ({variants}); losses "
              + ", ".join(f"{v:.4f}" for v in losses)
              + f" [{card}]")
        if launches[mode] != steps:
            raise AssertionError(f"{mode}: B1 launched {launches[mode]} times "
                                 f"in {steps} steps")
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"{mode}: non-finite loss {losses}")
    report["remat_timed"] = out
    return launches


def remat_phase(seed, device, card, report):
    t0 = time.monotonic()
    remat_check_phase(seed, device, card, report)
    print(f"phase remat-check: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    launches = remat_timed_phase(seed, device, card, report)
    print(f"phase remat-timed: {time.monotonic() - t0:.1f} s")
    return launches


# ------------------------------------------------------------- text path
# simple_rnn through the one-hot chain over the PTB-small file's lines
SIMPLE_RNN = {"vocab": 127, "hidden": 40, "length": 20, "batch": 20,
              "steps": 48, "lr": 0.005, "K": 4}
# examples/textclassification/train.py: at its defaults (400 texts,
# sequence 12, embedding 32, batch 32, six epochs, Adam lr 0.01), then
# timed at the widths of BigDL's TextClassifier example (sequence 1000,
# 100-d embeddings, batch 128) over 12,800 texts of the same corpus
TEXT_CNN = {"texts": 400, "seq": 12, "embed": 32, "batch": 32, "epochs": 6,
            "lr": 0.01, "min_acc": 0.9, "K": 4, "timed_texts": 12_800,
            "timed_seq": 1000, "timed_embed": 100, "timed_batch": 128,
            "profile_at": 80, "timed_from": 10}
# the text models' K=4 blocks on the card against the CPU, step by step
# (wd_step_reading): PTB-small's limit is TRAIN_TOL, which two planted
# faults must exceed; the SimpleRNN and the text CNN are held to the same
TEXT_TOL = TRAIN_TOL


def write_ptb_file(path, seed):
    """A PTB-format file (one sentence a line, words split by spaces) of
    PTB_SMALL["words"] words over PTB_SMALL["distinct"] tokens, ``<unk>``
    among them at rank 2 as in PTB: each token once, the rest drawn from a
    Zipf law over the ranks (p ~ 1/rank), shuffled, cut into sentences of
    5-35 words."""
    n, total = PTB_SMALL["distinct"], PTB_SMALL["words"]
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(n)]
    vocab[1] = "<unk>"
    p = 1.0 / np.arange(1, n + 1)
    ids = np.concatenate([np.arange(n),
                          rng.choice(n, size=total - n, p=p / p.sum())])
    rng.shuffle(ids)
    with open(path, "w") as f:
        at = 0
        while at < total:
            end = min(total, at + int(rng.integers(5, 36)))
            f.write(" ".join(vocab[i] for i in ids[at:end]) + "\n")
            at = end


def text_cnn_corpus(n=400, seed=0):
    """``synthetic_corpus`` of examples/textclassification/train.py (the
    example imports the reference package, so it is copied here): two
    topics of 20 preferred words each and 20 shared words, 12 words a
    text; (texts, labels)."""
    rng = np.random.default_rng(seed)
    topics = [[f"alpha{i}" for i in range(20)],
              [f"beta{i}" for i in range(20)]]
    shared = [f"w{i}" for i in range(20)]
    texts, labels = [], []
    for _ in range(n):
        y = int(rng.integers(0, 2))
        words = rng.choice(topics[y] + shared, size=12)
        texts.append(" ".join(words))
        labels.append(y)
    return texts, labels


def text_cnn_samples(texts, labels, seq_len):
    """The example's samples: tokenized, a Dictionary over every token,
    ids cut or zero-padded to ``seq_len``; (samples, vocabulary size)."""
    toks = [text.sentence_tokenizer(t) for t in texts]
    d = Dictionary(toks)
    samples = []
    for t, y in zip(toks, labels):
        ids = d.encode(t)[:seq_len]
        if len(ids) < seq_len:
            ids = np.pad(ids, (0, seq_len - len(ids)))
        samples.append(Sample(ids.astype(np.int32), np.int32(y)))
    return samples, d.vocab_size()


def max_over_time(x):
    return x.amax(1)


def text_cnn(vocab, embed):
    """The example's model: LookupTable >> TemporalConvolution(embed, 64,
    3) >> ReLU >> max over time (``amax``: tied maxima share the gradient,
    as the reference's ``max(axis=1)`` shares it) >> Linear(64, 2) >>
    LogSoftMax."""
    return nn.Sequential(nn.LookupTable(vocab, embed),
                         nn.TemporalConvolution(embed, 64, 3), nn.ReLU(),
                         nn.Lambda(max_over_time), nn.Linear(64, 2),
                         nn.LogSoftMax(), name="TextCNN")


def text_cpu_step(criterion):
    """``cpu_step`` of :func:`wd_step_reading` for a model fed one input
    tensor: the loss and gradients of one step on the CPU from
    ``params``."""
    def step(init, params, batch):
        m = copy.deepcopy(init)
        with torch.no_grad():
            for k, p in m.named_parameters():
                p.copy_(params[k])
                p.requires_grad_(True)
        loss = criterion.apply(m(torch.from_numpy(batch.input)),
                               torch.from_numpy(batch.target))
        loss.backward()
        return loss.item(), {k: p.grad.double()
                             for k, p in m.named_parameters()}
    return step


def text_train(model, dataset, device, end, criterion, lr, k,
               cls=LocalOptimizer, method=None):
    """Train ``model`` in place through ``cls`` with Adam at ``lr`` (or
    ``method``) in K=``k`` blocks until ``end``: (per-step losses, the host
    clock at each step's loss, optimizer, wall seconds)."""
    losses, clock = [], []

    class Recording(cls):
        def _log_train_iteration(self, lr):
            losses.append(self.state["loss"])
            clock.append(time.perf_counter())

    opt = (Recording(model, dataset, criterion, device=device)
           .set_optim_method(method or optim.Adam(learning_rate=lr))
           .set_steps_per_dispatch(k).set_end_when(end))
    t0 = time.monotonic()
    opt.optimize()
    return losses, clock, opt, time.monotonic() - t0


def text_check(label, init, samples, batch, criterion, lr, device, card,
               faults=()):
    """One K=4 block of ``init`` on the card through LocalOptimizer
    against the CPU step by step (:func:`wd_step_reading`), over the first
    4 batches of ``samples``; each of ``faults`` (name, context manager
    factory) planted on a card run of its own.  (sound, its four largest,
    {fault: reading})."""
    K = PTB_SMALL["K"]
    batches = [batch_samples(samples[j * batch:(j + 1) * batch])
               for j in range(K)]

    def card_run(ctx):
        adam = RecordingAdam(learning_rate=lr)
        with ctx():
            losses = text_train(
                copy.deepcopy(init), DataSet.array(np.zeros(K * batch))
                >> Prebuilt(batches, batch), device, optim.max_iteration(K),
                criterion, lr, K, method=adam)[0]
        return losses, adam.steps

    cpu_step = text_cpu_step(criterion)
    sound, worst = wd_step_reading(*card_run(contextlib.nullcontext), init,
                                   batches, cpu_step)
    readings = {name: wd_step_reading(*card_run(ctx), init, batches,
                                      cpu_step)[0] for name, ctx in faults}
    print(f"{label} train-vs-cpu check, {K} steps of batch {batch} step by "
          f"step: sound {sound:.3e} (largest {worst}), planted faults "
          + (", ".join(f"{k} {v:.3e}" for k, v in readings.items())
             or "none") + f" (tol {TEXT_TOL}) [{card}]")
    if not sound <= TEXT_TOL:
        raise AssertionError(f"{label} training on the card is {sound:.3e} "
                             f"from the CPU, over the limit {TEXT_TOL}")
    for fault, err in readings.items():
        if not err > TEXT_TOL:
            raise AssertionError(
                f"planted fault {fault} reads {err:.3e}, inside the "
                f"{label} tolerance {TEXT_TOL}: the check is blind")
    return sound, worst, readings


@contextlib.contextmanager
def lstm_fault(fault):
    """``planted_lstm_fault`` in the LSTM layer for the block."""
    recurrent.lstm_cell = planted_lstm_fault(fault, PTB_SMALL["T"])
    try:
        yield
    finally:
        recurrent.lstm_cell = lstm_cell.lstm_cell


def timed_run(label, model, dataset, device, end, criterion, lr, k, at,
              timed_from, per_step, unit, card):
    """A training run with block ``at`` profiled (:func:`profiled_block`):
    ms a step and ``unit``/s over steps ``timed_from`` to the profiled
    block's first (``per_step`` ``unit`` a step), the profile, the losses;
    a dict."""
    prof = {}
    cls = profiled_block(LocalOptimizer, at, card, 6, prof)
    torch.cuda.reset_peak_memory_stats()
    losses, clock, opt, wall = text_train(model, dataset, device, end,
                                          criterion, lr, k, cls=cls)
    peak = torch.cuda.max_memory_allocated()
    last = at * k - 1
    step_s = (clock[last] - clock[timed_from]) / (last - timed_from)
    print_profile(f"{label} block {at} (K={k})", prof, card, 6)
    print(f"train {label} K={k}: {len(losses)} steps in {wall:.1f} s; "
          f"steps {timed_from}-{last}: ms_per_step={step_s * 1e3:.3f} "
          f"{unit}_per_s={per_step / step_s:.1f} max_memory_allocated="
          f"{peak}; loss {np.mean(losses[:20]):.4f} (first 20 steps) -> "
          f"{np.mean(losses[-20:]):.4f} (last 20) [{card}]")
    return {"steps": len(losses), "wall_s": wall, "k": k,
            "ms_per_step": step_s * 1e3, f"{unit}_per_s": per_step / step_s,
            "max_memory_allocated": peak, "losses": losses, "profile": prof}


def ptb_small_phase(seed, device, card, report, tmp):
    """PTB-small through the text pipeline of examples/rnn/train.py:
    ``read_ptb_words`` >> ``Dictionary(vocab_size=10000)`` >>
    ``ptb_batches(ids, 20)`` >> Sample >> ``SampleToMiniBatch(20)``, then
    ``ptb_model(10000, 200, 200)`` with Adam and the time-distributed NLL:
    a K=4 block against the CPU (two planted faults), then one epoch of
    the file (B2f/B2b 20 launches a step each, the loss must fall, words/s,
    a profiled block).  Returns B2f's and B2b's launches in the epoch."""
    cfg = PTB_SMALL
    path = os.path.join(tmp, "ptb.train.txt")
    t0 = time.monotonic()
    write_ptb_file(path, seed)
    words = text.read_ptb_words(path)
    d = Dictionary([words], vocab_size=cfg["vocab"])
    if d.vocab_size() != cfg["vocab"] or "<unk>" not in d.word2index:
        raise AssertionError(f"the file's dictionary holds {d.vocab_size()} "
                             f"words, want {cfg['vocab']} with <unk>")
    x, y = text.ptb_batches(d.encode(words), cfg["T"])
    samples = [Sample(a, b) for a, b in zip(x, y)]
    print(f"ptb-small data: {len(words)} words ({words.count('<eos>')} "
          f"lines) -> {len(samples)} windows of {cfg['T']} in "
          f"{time.monotonic() - t0:.1f} s")
    init = ptb_model(cfg["vocab"], cfg["embed"], cfg["hidden"],
                     cfg["layers"]).initialize(seed)
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                       size_average=True)
    t0 = time.monotonic()
    sound, worst, faults = text_check(
        "ptb-small", init, samples, cfg["batch"], crit, cfg["lr"], device,
        card, [(f, lambda f=f: lstm_fault(f))
               for f in ("w_t_127_128", "one_step_dz_127_128")])
    print(f"phase text-ptb-small-vs-cpu: {time.monotonic() - t0:.1f} s")

    t0 = time.monotonic()
    k = Engine.steps_per_dispatch(backend=device.type)
    model = copy.deepcopy(init)
    lstm_cell.fwd_launches = lstm_cell.bwd_launches = 0
    run = timed_run("ptb-small epoch", model, DataSet.array(samples, seed=seed)
                    >> SampleToMiniBatch(cfg["batch"]), device,
                    optim.max_epoch(1), crit, cfg["lr"], k,
                    cfg["profile_at"] // k, cfg["timed_from"],
                    cfg["batch"] * cfg["T"], "words", card)
    launches = {"lstm_cell_fwd": lstm_cell.fwd_launches,
                "lstm_cell_bwd": lstm_cell.bwd_launches}
    steps, losses = run["steps"], run["losses"]
    if steps != -(-len(samples) // cfg["batch"]):  # the last batch wraps
        raise AssertionError(f"one epoch ran {steps} steps")
    for kernel, n in launches.items():
        if n != cfg["T"] * steps:
            raise AssertionError(f"{kernel} launched {n} times in {steps} "
                                 f"steps (want {cfg['T']} a step)")
    if not (np.all(np.isfinite(losses))
            and np.mean(losses[-20:]) < np.mean(losses[:20])):
        raise AssertionError(f"PTB-small's loss did not fall: "
                             f"{losses[:20]} ... {losses[-20:]}")
    print(f"ptb-small launches {launches} in {steps} steps [{card}]")
    print(f"phase text-ptb-small-epoch: {time.monotonic() - t0:.1f} s")
    report["ptb_small"] = {"sound": sound, "largest": worst,
                           "planted_faults": faults, "tol": TEXT_TOL,
                           "launches": launches, **run}
    return launches


def simple_rnn_phase(seed, device, card, report, tmp):
    """``simple_rnn`` over the PTB-small file's lines through the one-hot
    chain: ``SentenceTokenizer`` >> ``SentenceBiPadding`` >>
    ``Dictionary(vocab_size=127)`` >> ``TextToLabeledSentence`` >>
    ``LabeledSentenceToSample(20, one_hot=True)`` >>
    ``SampleToMiniBatch(20)``; a K=4 block against the CPU, then
    SIMPLE_RNN["steps"] steps whose loss must fall."""
    cfg = SIMPLE_RNN
    t0 = time.monotonic()
    with open(os.path.join(tmp, "ptb.train.txt")) as f:
        lines = f.read().splitlines()
    toks = list(text.SentenceBiPadding()(text.SentenceTokenizer()(
        iter(lines))))
    d = Dictionary(toks, vocab_size=cfg["vocab"])
    V = d.vocab_size()
    samples = list(text.LabeledSentenceToSample(
        cfg["length"], one_hot=True, vocab_size=V)(
            text.TextToLabeledSentence(d)(iter(toks))))
    init = simple_rnn(V, cfg["hidden"], V).initialize(seed)
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                       size_average=True)
    sound, worst, _ = text_check("simple-rnn", init, samples, cfg["batch"],
                                 crit, cfg["lr"], device, card)
    losses, clock, _, wall = text_train(
        copy.deepcopy(init), DataSet.array(samples, seed=seed)
        >> SampleToMiniBatch(cfg["batch"]), device,
        optim.max_iteration(cfg["steps"]), crit, cfg["lr"], cfg["K"])
    step_s = (clock[-1] - clock[cfg["K"] - 1]) / (len(losses) - cfg["K"])
    first, last = np.mean(losses[:8]), np.mean(losses[-8:])
    print(f"train simple-rnn V={V} (one-hot) hidden {cfg['hidden']} batch "
          f"{cfg['batch']} x {cfg['length']}: {len(samples)} sentences, "
          f"{len(losses)} steps in {wall:.1f} s, ms_per_step="
          f"{step_s * 1e3:.3f}; loss {first:.4f} (first 8) -> {last:.4f} "
          f"(last 8) [{card}]")
    if not (np.all(np.isfinite(losses)) and last < first):
        raise AssertionError(f"the SimpleRNN's loss did not fall: {losses}")
    print(f"phase text-simple-rnn: {time.monotonic() - t0:.1f} s")
    report["simple_rnn"] = {"vocab": V, "sound": sound, "largest": worst,
                            "tol": TEXT_TOL, "losses": losses,
                            "ms_per_step": step_s * 1e3}


def text_cnn_phase(seed, device, card, report):
    """examples/textclassification/train.py's text CNN: at its defaults, a
    K=4 block against the CPU and six epochs whose train accuracy must
    exceed TEXT_CNN["min_acc"]; then one timed epoch at sequence 1000,
    embedding 100, batch 128 (samples/s, a profiled block)."""
    cfg = TEXT_CNN
    t0 = time.monotonic()
    texts, labels = text_cnn_corpus(cfg["texts"], seed)
    samples, V = text_cnn_samples(texts, labels, cfg["seq"])
    init = text_cnn(V, cfg["embed"]).initialize(seed)
    crit = nn.ClassNLLCriterion()
    sound, worst, _ = text_check("text-cnn", init, samples, cfg["batch"],
                                 crit, cfg["lr"], device, card)
    model = copy.deepcopy(init)
    losses = text_train(model, DataSet.array(samples, seed=seed)
                        >> SampleToMiniBatch(cfg["batch"]), device,
                        optim.max_epoch(cfg["epochs"]), crit, cfg["lr"],
                        cfg["K"])[0]
    with torch.no_grad():
        net = copy.deepcopy(model).to(device).eval()
        xs = torch.from_numpy(np.stack([s.feature for s in samples]))
        pred = net(xs.to(device)).argmax(-1).cpu().numpy()
    acc = float((pred == np.asarray(labels)).mean())
    print(f"train text-cnn (the example's defaults: vocab {V}, sequence "
          f"{cfg['seq']}, embedding {cfg['embed']}, batch {cfg['batch']}, "
          f"{cfg['epochs']} epochs, {len(losses)} steps): loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, train accuracy {acc:.4f} "
          f"(must exceed {cfg['min_acc']}) [{card}]")
    if not acc > cfg["min_acc"]:
        raise AssertionError(f"the text CNN's train accuracy is {acc}")
    print(f"phase text-cnn: {time.monotonic() - t0:.1f} s")

    t0 = time.monotonic()
    texts, labels = text_cnn_corpus(cfg["timed_texts"], seed + 1)
    samples, V = text_cnn_samples(texts, labels, cfg["timed_seq"])
    k = Engine.steps_per_dispatch(backend=device.type)
    B = cfg["timed_batch"]
    run = timed_run(f"text-cnn sequence {cfg['timed_seq']} embedding "
                    f"{cfg['timed_embed']} batch {B}",
                    text_cnn(V, cfg["timed_embed"]).initialize(seed),
                    DataSet.array(samples, seed=seed) >> SampleToMiniBatch(B),
                    device, optim.max_epoch(1), crit, cfg["lr"], k,
                    cfg["profile_at"] // k, cfg["timed_from"], B, "samples",
                    card)
    print(f"phase text-cnn-timed: {time.monotonic() - t0:.1f} s")
    report["text_cnn"] = {"sound": sound, "largest": worst, "tol": TEXT_TOL,
                          "train_accuracy": acc, "losses": losses,
                          "timed": run}


def text_phase(seed, device, card, report):
    """The text path: PTB-small, the one-hot SimpleRNN chain, the text
    CNN.  Returns B2f's and B2b's launches in PTB-small's epoch."""
    with tempfile.TemporaryDirectory() as tmp:
        launches = ptb_small_phase(seed, device, card, report, tmp)
        torch.cuda.empty_cache()
        simple_rnn_phase(seed, device, card, report, tmp)
    torch.cuda.empty_cache()
    text_cnn_phase(seed, device, card, report)
    return launches


# ----------------------------------------------------------------- nn core
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixtures", "data")
# every layer and criterion of the text slice on the card against the CPU:
# the largest difference of any output or gradient as a share of that
# array's largest value on the CPU; above the sound readings (f32 ops in
# another order), below the two planted faults (a tie's gradient 1 or 0
# where the reference gives 0.5), which every run measures
NN_CORE_TOL = 1e-4


def _fixture(name, *keys):
    z = np.load(os.path.join(FIXTURES, f"{name}.npz"))
    return tuple(z[k].astype(np.float32) if z[k].dtype.kind == "f" else z[k]
                 for k in keys)


def _normal(gen, *shape):
    return gen.normal(size=shape).astype(np.float32)


def _tied(gen, *shape):
    """Normal values, each row's first two entries along the last axis
    equal, a few exact zeros."""
    x = _normal(gen, *shape)
    x[..., 1] = x[..., 0]
    x.reshape(-1)[::5] = 0.0
    return x


def _at_bounds(gen):
    x = _normal(gen, 4, 6)
    x[0, :2] = (-0.5, 0.8)
    return x


def _table(gen, n, *shape):
    xs = [_normal(gen, *shape) for _ in range(n)]
    xs[1].reshape(-1)[::2] = xs[0].reshape(-1)[::2]
    return tuple(xs)


def _uniform(gen, *shape):
    return gen.uniform(0.5, 2.0, shape).astype(np.float32)


# name: (module, input maker of a numpy Generator); a golden fixture's
# input where the class has one
NN_CORE_MODULES = {
    "View": (lambda: nn.View((6, 2)), lambda g: _normal(g, 2, 3, 4)),
    "Flatten": (nn.Flatten, lambda g: _normal(g, 2, 3, 4)),
    "Squeeze": (lambda: nn.Squeeze(1), lambda g: _normal(g, 2, 1, 4)),
    "Unsqueeze": (lambda: nn.Unsqueeze(1), lambda g: _normal(g, 2, 3)),
    "Transpose": (lambda: nn.Transpose([(1, 2), (0, 1)]),
                  lambda g: _normal(g, 2, 3, 4)),
    "Contiguous": (nn.Contiguous, lambda g: _normal(g, 3, 2)),
    "Narrow": (lambda: nn.Narrow(2, 1, -1), lambda g: _normal(g, 2, 3, 5)),
    "Select": (lambda: nn.Select(1, -1), lambda g: _normal(g, 2, 4, 3)),
    "Index": (lambda: nn.Index(1),
              lambda g: (_normal(g, 2, 5, 3),
                         g.integers(0, 5, (2, 3)).astype(np.int64))),
    "Padding": (lambda: nn.Padding(1, -2, 0.5),
                lambda g: _normal(g, 2, 3, 4)),
    "SpatialZeroPadding": (lambda: nn.SpatialZeroPadding(1, 2, 0, 1),
                           lambda g: _normal(g, 2, 3, 4, 5)),
    "JoinTable": (lambda: nn.JoinTable(1),
                  lambda g: (_normal(g, 2, 3), _normal(g, 2, 4))),
    "SplitTable": (lambda: nn.SplitTable(1), lambda g: _normal(g, 2, 3, 4)),
    "CMulTable": (nn.CMulTable, lambda g: _table(g, 3, 2, 5)),
    "CSubTable": (nn.CSubTable, lambda g: _table(g, 2, 2, 5)),
    "CDivTable": (nn.CDivTable,
                  lambda g: (_normal(g, 2, 5), _uniform(g, 2, 5))),
    "CMaxTable": (nn.CMaxTable, lambda g: _table(g, 3, 2, 5)),
    "CMinTable": (nn.CMinTable, lambda g: _table(g, 3, 2, 5)),
    "FlattenTable": (nn.FlattenTable,
                     lambda g: ((_normal(g, 2, 3), (_normal(g, 2, 2),)),
                                _normal(g, 2, 1))),
    "SelectTable": (lambda: nn.SelectTable(0),
                    lambda g: (_normal(g, 2, 3), _normal(g, 2, 4))),
    "MulConstant": (lambda: nn.MulConstant(2.5), lambda g: _normal(g, 2, 3)),
    "AddConstant": (lambda: nn.AddConstant(-1.5), lambda g: _normal(g, 2, 3)),
    "Power": (lambda: nn.Power(1.5, 2.0, 1.0),
              lambda g: _fixture("power", "x")[0]),
    "Sqrt": (nn.Sqrt, lambda g: _uniform(g, 2, 3)),
    "Square": (nn.Square, lambda g: _normal(g, 2, 3)),
    "Abs": (nn.Abs, lambda g: _tied(g, 3, 4)),
    "Exp": (nn.Exp, lambda g: _normal(g, 2, 3)),
    "Log": (nn.Log, lambda g: _uniform(g, 2, 3)),
    "Clamp": (lambda: nn.Clamp(-0.5, 0.8),
              lambda g: _fixture("clamp", "x")[0]),
    "Clamp_at_bounds": (lambda: nn.Clamp(-0.5, 0.8), _at_bounds),
    "Mean": (lambda: nn.Mean(1), lambda g: _normal(g, 2, 3, 4)),
    "Sum": (lambda: nn.Sum(2, False), lambda g: _normal(g, 2, 3, 4)),
    "Max": (lambda: nn.Max(2), lambda g: _tied(g, 2, 3, 4)),
    "Min": (lambda: nn.Min(2), lambda g: _tied(g, 2, 3, 4)),
    "Replicate": (lambda: nn.Replicate(3, 1), lambda g: _normal(g, 2, 4)),
    "Pack": (lambda: nn.Pack(1),
             lambda g: (_normal(g, 2, 3), _normal(g, 2, 3))),
    "Scale": (lambda: nn.Scale((1, 4)), lambda g: _normal(g, 3, 4)),
    "Masking": (nn.Masking, lambda g: np.where(
        g.random((2, 5, 1)) < .3, 0.0, _normal(g, 2, 5, 3)).astype(
            np.float32)),
    "CMul": (lambda: nn.CMul((1, 6)), lambda g: _fixture("cmul", "x")[0]),
    "CAdd": (lambda: nn.CAdd((1, 6)), lambda g: _fixture("cadd", "x")[0]),
    "Normalize": (lambda: nn.Normalize(1.5), lambda g: _normal(g, 3, 5, 2)),
    "NormalizeScale": (lambda: nn.NormalizeScale(2.0, 1e-10, 20.0,
                                                 (1, 4, 1, 1)),
                       lambda g: _normal(g, 2, 4, 3, 3)),
    "TemporalConvolution": (lambda: nn.TemporalConvolution(5, 6, 3, 2),
                            lambda g: _fixture("temporal_convolution",
                                               "x")[0]),
    "SpatialFullConvolution": (
        lambda: nn.SpatialFullConvolution(4, 3, 3, 3, 2, 2, 1, 1, 1, 1),
        lambda g: _fixture("spatial_full_convolution", "x")[0]),
    "SpatialFullConvolution_adj_over_stride": (
        lambda: nn.SpatialFullConvolution(2, 3, 3, 3, 2, 2, 1, 1, 2, 3),
        lambda g: _normal(g, 2, 2, 4, 4)),
    "Lambda": (lambda: nn.Lambda(max_over_time), lambda g: _tied(g, 2, 5, 3)),
    "Echo": (nn.Echo, lambda g: _normal(g, 2, 3)),
}


def _pair_fixture(name):
    x1, x2, t = _fixture(f"crit2_{name}", "x1", "x2", "target")
    return (x1, x2), t


def _crit_fixture(name):
    return _fixture(f"crit_{name}", "x", "target")


def _masked_steps(g):
    t = g.integers(1, 5, (3, 4)).astype(np.int64)
    t[0, 2:] = 0
    x = np.log(g.dirichlet(np.ones(5), (3, 4))).astype(np.float32)
    return x, t


# name: (criterion, (input, target) maker)
NN_CORE_CRITERIA = {
    "AbsCriterion": (nn.AbsCriterion, lambda g: _crit_fixture("abs")),
    "SmoothL1Criterion": (nn.SmoothL1Criterion,
                          lambda g: _crit_fixture("smooth_l1")),
    "DistKLDivCriterion": (nn.DistKLDivCriterion,
                           lambda g: _crit_fixture("dist_kl")),
    "KLDCriterion": (nn.KLDCriterion, lambda g: _pair_fixture("kld_vae")),
    "GaussianCriterion": (nn.GaussianCriterion,
                          lambda g: _pair_fixture("gaussian")),
    "MarginCriterion": (nn.MarginCriterion, lambda g: _crit_fixture("margin")),
    "MarginRankingCriterion": (nn.MarginRankingCriterion,
                               lambda g: _pair_fixture("margin_ranking")),
    "CosineEmbeddingCriterion": (
        lambda: nn.CosineEmbeddingCriterion(0.2),
        lambda g: _pair_fixture("cosine_embedding")),
    "HingeEmbeddingCriterion": (nn.HingeEmbeddingCriterion,
                                lambda g: _crit_fixture("hinge_embedding")),
    "SoftMarginCriterion": (nn.SoftMarginCriterion,
                            lambda g: _crit_fixture("soft_margin")),
    "L1Cost": (nn.L1Cost, lambda g: _crit_fixture("l1_cost")),
    "DiceCoefficientCriterion": (nn.DiceCoefficientCriterion,
                                 lambda g: _crit_fixture("dice")),
    "MultiLabelSoftMarginCriterion": (
        nn.MultiLabelSoftMarginCriterion,
        lambda g: _crit_fixture("multilabel_soft_margin")),
    "MultiCriterion": (lambda: nn.MultiCriterion().add(nn.MSECriterion(), .5)
                       .add(nn.AbsCriterion(), 2.0),
                       lambda g: (_normal(g, 3, 4), _normal(g, 3, 4))),
    "ParallelCriterion": (
        lambda: nn.ParallelCriterion().add(nn.ClassNLLCriterion())
        .add(nn.MSECriterion(), .25),
        lambda g: ((np.log(g.dirichlet(np.ones(3), 4)).astype(np.float32),
                    _normal(g, 4, 2)),
                   (g.integers(0, 3, 4), _normal(g, 4, 2)))),
    "PGCriterion": (nn.PGCriterion, lambda g: _crit_fixture("pg")),
    "MultiLabelMarginCriterion": (nn.MultiLabelMarginCriterion,
                                  lambda g: _crit_fixture(
                                      "multilabel_margin")),
    "SoftmaxWithCriterion": (nn.SoftmaxWithCriterion,
                             lambda g: _crit_fixture("softmax_with")),
    "CosineDistanceCriterion": (nn.CosineDistanceCriterion,
                                lambda g: _crit_fixture("cosine_distance")),
    "CosineProximityCriterion": (nn.CosineProximityCriterion,
                                 lambda g: _crit_fixture(
                                     "cosine_proximity")),
    "DotProductCriterion": (nn.DotProductCriterion,
                            lambda g: _crit_fixture("dot_product")),
    "KullbackLeiblerDivergenceCriterion": (
        nn.KullbackLeiblerDivergenceCriterion,
        lambda g: _crit_fixture("kl_probs")),
    "L1HingeEmbeddingCriterion": (
        nn.L1HingeEmbeddingCriterion,
        lambda g: _pair_fixture("l1_hinge_embedding")),
    "MeanAbsolutePercentageCriterion": (nn.MeanAbsolutePercentageCriterion,
                                        lambda g: _crit_fixture("mape")),
    "MeanSquaredLogarithmicCriterion": (nn.MeanSquaredLogarithmicCriterion,
                                        lambda g: _crit_fixture("msle")),
    "MultiMarginCriterion": (lambda: nn.MultiMarginCriterion(p=2),
                             lambda g: _crit_fixture("multi_margin_p2")),
    "PoissonCriterion": (nn.PoissonCriterion,
                         lambda g: _crit_fixture("poisson")),
    "ClassSimplexCriterion": (lambda: nn.ClassSimplexCriterion(4),
                              lambda g: _crit_fixture("class_simplex")),
    "SmoothL1CriterionWithWeights": (
        lambda: nn.SmoothL1CriterionWithWeights(2.0, 3),
        lambda g: (_normal(g, 3, 4), (_normal(g, 3, 4),
                                      np.abs(_normal(g, 3, 4)),
                                      np.abs(_normal(g, 3, 4))))),
    "TimeDistributedMaskCriterion": (
        lambda: nn.TimeDistributedMaskCriterion(nn.ClassNLLCriterion(
            weights=[1, .5, 2, 1, 3])), _masked_steps),
    "TransformerCriterion": (
        lambda: nn.TransformerCriterion(nn.MSECriterion(),
                                        nn.Linear(4, 3).initialize(5)),
        lambda g: (_normal(g, 5, 4), _normal(g, 5, 3))),
    "CategoricalCrossEntropy": (nn.CategoricalCrossEntropy,
                                lambda g: _crit_fixture("categorical_ce")),
}


class ClampOnTorchClamp(nn.Clamp):
    """A planted fault: Clamp written with ``torch.clamp`` (gradient 1 at
    a bound, where the reference gives 0.5)."""

    def forward(self, x):
        return torch.clamp(x, self.min_v, self.max_v)


class MaxOnTorchMax(nn.Max):
    """A planted fault: Max written with ``torch.max(x, dim)`` (the whole
    gradient to one of tied maxima, where the reference shares it)."""

    def forward(self, x):
        return torch.max(x, self.dim).values


# fault: (the NN_CORE_MODULES case whose input it is fed, the module)
NN_CORE_FAULTS = {
    "clamp_on_torch_clamp": ("Clamp_at_bounds",
                             lambda: ClampOnTorchClamp(-0.5, 0.8)),
    "max_on_torch_max": ("Max", lambda: MaxOnTorchMax(2))}


def _tree(fn, x):
    if isinstance(x, (tuple, list)):
        return type(x)(_tree(fn, e) for e in x)
    return fn(x)


def _flat_leaves(x):
    if isinstance(x, (tuple, list)):
        return [e for t in x for e in _flat_leaves(t)]
    return [x]


def core_run(module, criterion, x, t, device, cot_seed):
    """The outputs and the gradients with respect to every float input
    and parameter of ``module(x)`` (against seeded cotangents) or of
    ``criterion.apply(x, t)``, on ``device``: a list of CPU tensors."""
    xs = _tree(lambda a: torch.from_numpy(np.array(a)).to(device)
               .requires_grad_(a.dtype.kind == "f"), x)
    params = []
    if module is not None:
        module = module.to(device)
        params = [p.requires_grad_(True) for p in module.parameters()]
        outs = _flat_leaves(module(xs))
        gen = np.random.default_rng(cot_seed)
        loss = sum((o * torch.from_numpy(_normal(gen, *o.shape)).to(device))
                   .sum() for o in outs)
    else:
        loss = criterion.apply(xs, _tree(lambda a: torch.from_numpy(
            np.array(a)).to(device), t))
        outs = [loss]
    floats = [a for a in _flat_leaves(xs) if a.requires_grad] + params
    grads = torch.autograd.grad(loss, floats, allow_unused=True)
    return [o.detach().cpu() for o in outs] + [
        torch.zeros(a.shape) if g is None else g.cpu()
        for a, g in zip(floats, grads)]


def core_reading(got, want):
    """The largest difference over the arrays, each as a share of its own
    largest value on the CPU."""
    return max(((g.double() - w.double()).abs().max()
                / max(w.double().abs().max().item(), 1e-30)).item()
               for g, w in zip(got, want))


def nn_core_phase(seed, device, card, report):
    """Every layer and criterion of the text slice (the 37 shape and table
    ops, CMul, CAdd, Normalize, NormalizeScale, TemporalConvolution,
    SpatialFullConvolution, Lambda, Echo and the 32 criteria) through its
    forward and its input and parameter gradients on the card against the
    CPU, at its golden fixture's input or a small seeded one; each reading
    within NN_CORE_TOL, which two planted faults must exceed."""
    readings, inputs_of = {}, {}
    cases = [(name, make, None, inputs) for name, (make, inputs)
             in NN_CORE_MODULES.items()]
    cases += [(name, None, make, inputs) for name, (make, inputs)
              in NN_CORE_CRITERIA.items()]
    for i, (name, make_module, make_crit, inputs) in enumerate(cases):
        data = inputs(np.random.default_rng(seed + i))
        x, t = (data, None) if make_module else data
        module = make_module().initialize(seed + i) if make_module else None
        crit = make_crit() if make_crit else None
        # cotangents from a seed of their own: drawn from the input's, a
        # cotangent equal to the input can make a gradient vanish
        cot_seed = 10_000 + seed + i
        inputs_of[name] = (x, cot_seed)
        want = core_run(copy.deepcopy(module), crit, x, t, "cpu", cot_seed)
        got = core_run(module, crit, x, t, device, cot_seed)
        readings[name] = core_reading(got, want)
    faults = {}
    for fault, (case, make) in NN_CORE_FAULTS.items():
        x, cot_seed = inputs_of[case]
        want = core_run(NN_CORE_MODULES[case][0](), None, x, None, "cpu",
                        cot_seed)
        faults[fault] = core_reading(
            core_run(make(), None, x, None, device, cot_seed), want)
    worst = sorted(readings.items(), key=lambda kv: -kv[1])[:5]
    print(f"nn-core check: {len(NN_CORE_MODULES)} layer cases and "
          f"{len(NN_CORE_CRITERIA)} criteria, card against CPU, largest "
          f"shares {worst}; planted faults "
          + ", ".join(f"{k} {v:.3e}" for k, v in faults.items())
          + f" (tol {NN_CORE_TOL}) [{card}]")
    report["nn_core"] = {"readings": readings, "planted_faults": faults,
                         "tol": NN_CORE_TOL}
    over = {k: v for k, v in readings.items() if not v <= NN_CORE_TOL}
    if over:
        raise AssertionError(f"nn-core readings over {NN_CORE_TOL}: {over}")
    for fault, err in faults.items():
        if not err > NN_CORE_TOL:
            raise AssertionError(f"planted fault {fault} reads {err:.3e}, "
                                 f"inside {NN_CORE_TOL}: the check is blind")


# ------------------------------------------------------------ resilience
# the resilience and telemetry slice (resilience/, telemetry/,
# utils/{lockdep,spmdcheck,profiling,metrics}.py) on the main paths
RESIL = {"ptb_steps": 32, "profile_steps": 400, "profile_tries": 8,
         "validate_every": 16,
         "val_batches": 1, "lenet_K": 4, "lenet_steps": 24,
         "lenet_every": 4, "elastic_steps": 8, "elastic_batch": 64,
         "serve_requests": 7, "serve_rows": 2, "serve_max_batch": 4}
# the fault plans; each LeNet clause has a firing budget of one: an at=
# clause with no count= fires again on every retry of its dispatch (the
# driver's retries would all fail and the run with them) and on every
# rollback's re-run of its step, in both packages
LENET_PLAN = ("dispatch_error@where=driver,at=3,count=1;"
              "corrupt_batch@at=5,count=1;nonfinite_grads@at=9,count=1")
ELASTIC_PLAN = "resize@at=2,to=1;resize@at=5,to=2"
LOSS_PLAN = "device_loss@at=4"
SERVE_PLAN = "dispatch_error@at=2;replica_death@at=4"
ELASTIC_BOUNDARY = 3  # at=2 ends the block of step 3: model.3 resumes
# the elastic trajectory against an uninterrupted world-2 run, step by
# step: the largest relative loss difference at each iteration and, per
# weight array, the largest difference as a share of the array's largest
# value.  Above the sound reading (one process summing the global batch
# of 128 where two summed 64 each), below the two planted faults every
# run measures: each resume taking the weights of the snapshot one step
# before the boundary (the boundary's counters kept: a step lost), and
# the world-1 segment sharded and counted at the launch world's scale
# (rank 0 alone training on its half of each global batch)
ELASTIC_TOL = 1e-4
ELASTIC_FAULTS = ("weights_one_step_early", "launch_world_scale")


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def admin_get(port, path, timeout=60):
    """(status, body) of one GET to the admin plane on loopback."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class AdminPoller:
    """A client thread that, while a run is going, asks the admin plane
    for each of ``paths`` until each has answered once and, with
    ``profile_tries``, takes ``/profile?seconds=1`` captures until one
    holds B2f's kernel (at most that many), the first once ``started`` is
    set.  ``done`` is set when it has all it asked for."""

    def __init__(self, port, paths, profile_tries=0, started=None):
        self.port, self.paths, self.tries = port, paths, profile_tries
        self.started = started
        self.answers = {}
        # (status, kernels, B2f kernels, the window's retakes) a capture
        self.captures = []
        self.done = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _capture(self):
        try:
            code, body = admin_get(self.port, "/profile?seconds=1")
        except OSError as e:  # recorded: the check then fails on it
            self.captures.append((repr(e), 0, 0, None))
            return
        kernels, retakes = [], None
        if code == 200:
            answer = json.loads(body)
            retakes = answer["retakes"]
            with open(os.path.join(answer["log_dir"], "trace.json")) as f:
                kernels = [e["name"] for e in json.load(f)["traceEvents"]
                           if e.get("cat") == "kernel"]
        self.captures.append((code, len(kernels), sum(
            "lstm_cell_fwd" in k for k in kernels), retakes))

    def _run(self):
        from bigdl_tpu_torch.telemetry import admin
        while not self._stop.is_set() and (
                admin.current() is None or self.started is not None
                and not self.started.is_set()):
            time.sleep(0.005)
        while not self._stop.is_set():
            for path in self.paths:
                if path not in self.answers:
                    code, body = admin_get(self.port, path)
                    if code in (200, 503):  # /healthz says 503 on a stall
                        self.answers[path] = (code, body)
            profiled = not self.tries or len(self.captures) >= self.tries \
                or any(c[2] for c in self.captures)
            if not profiled:
                self._capture()
                continue
            if len(self.answers) == len(self.paths):
                self.done.set()
                return
            time.sleep(0.02)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=120)


def trace_phases(path):
    """Seconds a phase category of a Chrome trace, read as
    ``tools/trace_report.py`` reads one: the "X" events of
    ``traceEvents``, ``dur`` in microseconds."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    out = {}
    for e in events:
        if e.get("ph") == "X":
            for key in ("name", "ts", "dur", "pid", "tid"):
                if key not in e:
                    raise AssertionError(f"trace event without {key}: {e}")
            cat = e.get("cat") or "uncategorized"
            out[cat] = out.get(cat, 0.0) + e["dur"] / 1e6
    return out


def ptb_telemetry_run(init, samples, seed, device, steps, val, tel=None,
                      end=None):
    """PTB-medium through LocalOptimizer as the training phase runs it, a
    validation (the Loss) every RESIL["validate_every"] steps for the
    trigger spans, for ``steps`` steps (or until the trigger ``end``);
    ``tel``: the trace path (telemetry on).  (losses, optimizer, wall s,
    the B2f/B2b launches of the training steps, those of the validation
    forwards)."""
    losses, val_launches = [], [0, 0]

    class Recording(LocalOptimizer):
        def _log_train_iteration(self, lr):
            losses.append(self.state["loss"])

        def evaluate_with(self, net):  # count the forwards apart
            f, b = lstm_cell.fwd_launches, lstm_cell.bwd_launches
            try:
                return super().evaluate_with(net)
            finally:
                val_launches[0] += lstm_cell.fwd_launches - f
                val_launches[1] += lstm_cell.bwd_launches - b
                lstm_cell.fwd_launches, lstm_cell.bwd_launches = f, b

    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion())
    opt = (Recording(copy.deepcopy(init), DataSet.array(samples, seed=seed)
                     >> SampleToMiniBatch(PTB["batch"]), crit, device=device)
           .set_optim_method(optim.SGD(learning_rate=1.0))
           .set_gradient_clipping_by_l2_norm(5.0)
           .set_steps_per_dispatch(PTB["K"]).set_seed(seed)
           .set_validation(optim.several_iteration(RESIL["validate_every"]),
                           val, [optim.Loss(crit)])
           .set_end_when(end or optim.max_iteration(steps)))
    if tel is not None:
        opt.set_telemetry(True, trace_path=tel)
    lstm_cell.fwd_launches = lstm_cell.bwd_launches = 0
    t0 = time.monotonic()
    opt.optimize()
    wall = time.monotonic() - t0
    return (losses, opt, wall,
            {"lstm_cell_fwd": lstm_cell.fwd_launches,
             "lstm_cell_bwd": lstm_cell.bwd_launches},
            {"lstm_cell_fwd": val_launches[0],
             "lstm_cell_bwd": val_launches[1]})


def ptb_telemetry_phase(seed, device, card, report, tmp):
    """PTB-medium, RESIL["ptb_steps"] steps, with everything off and then
    with telemetry (a trace path), the flight recorder, the admin plane,
    lockdep and spmdcheck on: the losses bitwise equal, B2f/B2b 35
    launches a step in each, the trace's five phase categories, the four
    admin endpoints answering during the run, the memory gauges against
    the allocator's counters; then a third run during which a
    ``/profile?seconds=1`` capture must hold B2f's kernel."""
    from bigdl_tpu_torch.telemetry import PHASE_CATS, admin, flight
    from bigdl_tpu_torch.utils import config, lockdep, spmdcheck
    # B2f and B2b against their plain versions at the shape this path
    # launches them at
    cell_check([(PTB["batch"], PTB["hidden"])], device, card,
               torch.Generator(device=device).manual_seed(4321))
    samples = ptb_samples(seed)
    val = DataSet.array(samples[:PTB["batch"] * RESIL["val_batches"]]) \
        >> SampleToMiniBatch(PTB["batch"], drop_remainder=False)
    init = ptb_model(PTB["vocab"], PTB["embed"], PTB["hidden"],
                     PTB["layers"]).initialize(seed)
    steps = RESIL["ptb_steps"]
    want = PTB["T"] * steps
    # two runs of the same steps, compared bitwise: the deterministic
    # algorithms (the CUBLAS_WORKSPACE_CONFIG set above) in both
    torch.use_deterministic_algorithms(True)
    try:
        return ptb_telemetry_checks(init, samples, val, seed, device, card,
                                    report, tmp, steps, want)
    finally:
        torch.use_deterministic_algorithms(False)


def ptb_telemetry_checks(init, samples, val, seed, device, card, report,
                         tmp, steps, want):
    from bigdl_tpu_torch.telemetry import PHASE_CATS, admin, flight
    from bigdl_tpu_torch.utils import config, lockdep, spmdcheck
    # a warm-up run: the card's first blocks (cuBLAS, the allocator) are
    # paid here, not by the timed off run
    ptb_telemetry_run(init, samples, seed, device, PTB["K"], val)
    off_l, off_opt, off_s, off_n, off_val = ptb_telemetry_run(
        init, samples, seed, device, steps, val)
    if off_opt._telemetry is not None or off_opt._flight is not None \
            or admin.current() is not None:
        raise AssertionError("telemetry off built a telemetry object")

    port = free_port()
    trace = os.path.join(tmp, "ptb_trace.json")
    fpath = os.path.join(tmp, "ptb_flight.jsonl")
    config.configure(flight_recorder_path=fpath, admin_port=port,
                     lockdep=True, spmdcheck=True)
    paths = ("/metrics", "/healthz", "/trace", "/flight")
    try:
        lockdep.maybe_install()
        spmdcheck.maybe_install()
        with AdminPoller(port, paths) as poll:
            on_l, on_opt, on_s, on_n, on_val = ptb_telemetry_run(
                init, samples, seed, device, steps, val, tel=trace)
        tel = on_opt._telemetry
        # the gauges against the allocator's counters, read at one point
        got = tel.memory.observe()
        raw = torch.cuda.memory_stats(device)
        mem = {"bytes_in_use": raw["allocated_bytes.all.current"],
               "peak_bytes_in_use": raw["allocated_bytes.all.peak"],
               "bytes_limit": torch.cuda.mem_get_info(device)[1]}
        snap = on_opt.telemetry_snapshot()
        verdict = tel.health_snapshot()  # the run's /healthz at its end
        cycles, notes = lockdep.cycles(), spmdcheck.notes_recorded()
        divs = spmdcheck.divergences(final=True)
        proxies = lockdep.proxies_allocated()
    finally:
        lockdep.uninstall()
        lockdep.reset()
        spmdcheck.uninstall()
        admin.reset()
        flight.reset()
        config.reset_config()
    phases = trace_phases(trace)
    events = [e["event"] for e in
              flight.load_dump(fpath)["events"]]
    dogs = snap["watchdogs"]
    checks = {
        "losses_bitwise": on_l == off_l and len(on_l) == steps,
        "launches": off_n == on_n == {k: want for k in LSTM_KERNELS},
        "validation_launches_apart": off_val == on_val,
        "phase_cats": all(c in phases for c in PHASE_CATS),
        "admin_answered": {p: poll.answers.get(p, (None,))[0]
                           for p in paths},
        "memory_gauges_are_the_allocators": got == mem and all(
            snap["gauges"].get(f"device/{k}") is not None for k in mem),
        "no_recompile": dogs["recompile_events"] == [],
        "lockdep_clean": cycles == [] and proxies > 0,
        "spmdcheck_clean": divs == [] and notes > 0,
    }
    checks["admin_answered_all"] = all(
        c in (200, 503) for c in checks["admin_answered"].values())
    metrics = poll.answers.get("/metrics", (None, b""))[1].decode()
    health = json.loads(poll.answers.get("/healthz", (None, b"{}"))[1])
    checks["metrics_holds_the_driver"] = 'source="driver"' in metrics

    # a third run, training until a /profile?seconds=1 capture taken
    # while it trains (from the end of its first block) holds B2f
    # (RESIL["profile_tries"] captures at most, RESIL["profile_steps"]
    # steps at most)
    config.configure(admin_port=port)
    trained = threading.Event()

    def end(s):
        if s["neval"] > 0:
            trained.set()
        return prof_poll.done.is_set() or s["neval"] >= RESIL["profile_steps"]

    try:
        with AdminPoller(port, (), RESIL["profile_tries"],
                         started=trained) as prof_poll:
            ptb_telemetry_run(
                init, samples, seed, device, RESIL["profile_steps"], val,
                tel=os.path.join(tmp, "ptb_trace3.json"), end=end)
    finally:
        admin.reset()
        config.reset_config()
    captures = prof_poll.captures
    b2f = max((c[2] for c in captures), default=0)
    checks["profile_holds_b2f"] = b2f > 0 and all(
        c[0] == 200 for c in captures)
    words = PTB["batch"] * PTB["T"]
    print(f"resilience ptb-medium {steps} steps K={PTB['K']}, telemetry "
          f"off / on (trace, flight recorder, admin on 127.0.0.1:{port}, "
          f"lockdep, spmdcheck): ms_per_step {off_s / steps * 1e3:.3f} / "
          f"{on_s / steps * 1e3:.3f} (each run's wall over its steps, the "
          f"model's copy to the card and validation included); words/s "
          f"{words * steps / off_s:.1f} / {words * steps / on_s:.1f}; "
          f"phase fractions "
          + ", ".join(f"{k} {v:.4f}" for k, v in
                      dogs["phase_fractions"].items())
          + f"; trace seconds "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(phases.items()))
          + f"; stalls: host_sync {dogs['host_sync_stall_events']}, "
          f"stager_starvation {dogs['stager_starvation_events']} of "
          f"{dogs['blocks_observed']} blocks; /healthz during the run "
          f"{checks['admin_answered']['/healthz']} (ok={health.get('ok')}),"
          f" at its end ok={verdict['ok']}; memory gauges {got}; flight "
          f"events "
          f"{sorted(set(events))}; lockdep {proxies} locks, "
          f"{len(cycles)} cycles; spmdcheck {notes} notes; launches "
          f"{on_n} (+ validation {on_val}); /profile captures (status, "
          f"kernels, B2f kernels, retakes): {captures} [{card}]")
    report["resilience_ptb"] = {
        "checks": checks, "off_s": off_s, "on_s": on_s, "steps": steps,
        "losses": on_l, "phase_fractions": dogs["phase_fractions"],
        "trace_phase_s": phases, "watchdogs": dogs, "memory": got,
        "health": health, "health_at_end": verdict, "launches": on_n,
        "validation_launches": on_val, "profile_captures": captures}
    failed = [k for k, v in checks.items() if v is not True
              and k != "admin_answered"]
    if failed:
        raise AssertionError(f"resilience ptb check failed: {failed}: "
                             f"{ {k: checks[k] for k in failed} }; "
                             f"/profile captures (status, kernels, B2f "
                             f"kernels, retakes): {captures}")
    return on_n


def lenet_fault_run(init, data, device, policy, tmp):
    """LeNet's recipe, K=RESIL["lenet_K"], under LENET_PLAN and the
    numeric guard's ``policy`` (rollback: a snapshot every
    RESIL["lenet_every"] steps): (losses, optimizer, B1 launches, the
    flight events)."""
    from bigdl_tpu_torch.telemetry import flight
    from bigdl_tpu_torch.utils import config
    tmp = tempfile.mkdtemp(dir=tmp)  # this run's own
    fpath = os.path.join(tmp, "flight.jsonl")
    config.configure(fault_plan=LENET_PLAN, flight_recorder_path=fpath)
    losses = []
    try:
        K, B, n = RESIL["lenet_K"], LENET["batch"], RESIL["lenet_steps"]
        sgd = lenet_sgd(recording(optim.SGD))
        opt = (LocalOptimizer(copy.deepcopy(init),
                              lenet_pipeline(data, True, n * B),
                              nn.ClassNLLCriterion(), device=device)
               .set_optim_method(sgd).set_steps_per_dispatch(K)
               .set_numeric_guard(policy)
               .set_end_when(optim.max_iteration(n)))
        if policy == "rollback":
            opt.set_checkpoint(os.path.join(tmp, "ck"),
                               optim.several_iteration(RESIL["lenet_every"]))
        opt._log_train_iteration = lambda lr: losses.append(
            opt.state["loss"])
        maxpool.reset_counts()
        opt.optimize()
        launches = lenet_b1_launches(f"lenet under faults ({policy})")
    finally:
        flight.reset()
        config.reset_config()
    events = [(e["event"], e.get("step"), e.get("policy"))
              for e in flight.load_dump(fpath)["events"]
              if e["event"] in ("nonfinite_step", "rollback", "run_crash")]
    return losses, opt, launches, events, sgd.steps


def lenet_faults_phase(seed, device, card, report, tmp):
    """LeNet-5 under LENET_PLAN with the guard's skip policy, and under
    rollback with a snapshot every RESIL["lenet_every"] steps: each run
    completes, the flight recorder lists the reference's events for each
    clause, the retry is counted, the skipped steps are exactly 5 and 9,
    the skip run is within LENET_TRAIN_TOL of the same plan on the CPU
    step by step, and B1 launches 2 a step."""
    train, _ = lenet_data()
    gen = torch.Generator(device=device).manual_seed(1618)
    for name in LENET_POOL_CASES:
        pool_case_check(pool_case(name), gen, device)
    init = lenet5(10).initialize(seed + 3)
    n = RESIL["lenet_steps"]
    cpu = torch.device("cpu")
    runs = {(p, d.type): lenet_fault_run(init, train, d, p, tmp)
            for p in ("skip", "rollback") for d in (device, cpu)}
    skip = runs["skip", device.type]
    bad = [j for j, v in enumerate(skip[0]) if not np.isfinite(v)]
    counters = {p: {k: v for k, v in runs[p, device.type][1].metrics
                    .registry.snapshot()["counters"].items()
                    if k.startswith("resilience/")} for p in ("skip",
                                                            "rollback")}
    # step by step against the CPU run of the same plan: the relative
    # loss difference at each step (the gate); beside it, printed, the
    # gradients of each step from the card's own weights against the
    # CPU's LeNet step there, each by its norm share.  Not gated: over 22
    # steps a near-tie in a pool window (tanh outputs a rounding apart)
    # can send one element's gradient to its neighbour on one device and
    # not on the other, which read 4.3e-4 at step 20 in some runs and
    # ~1e-6 in others
    c_losses = runs["skip", "cpu"][0]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(skip[0], c_losses)
                   if np.isfinite(b))
    steps = [s for j, s in enumerate(skip[4]) if j not in bad]
    fin_losses = [v for j, v in enumerate(skip[0]) if j not in bad]
    batches = [b for j, b in enumerate(lenet_pipeline(
        train, True, n * LENET["batch"]).data(train=False)) if j not in bad]
    sound, worst = wd_step_reading(fin_losses, steps, init, batches,
                                   lenet_cpu_step, share=norm_share)
    roll = runs["rollback", device.type]
    checks = {
        "skipped_steps_5_and_9": bad == [5, 9] and len(skip[0]) == n,
        "skip_events": skip[3] == [("nonfinite_step", 5, "skip"),
                                   ("nonfinite_step", 9, "skip")],
        "skip_counters": counters["skip"] == {
            "resilience/dispatch_retries": 1,
            "resilience/fault_dispatch_error": 1,
            "resilience/fault_corrupt_batch": 1,
            "resilience/fault_nonfinite_grads": 1,
            "resilience/nonfinite_steps": 2, "resilience/steps_skipped": 2},
        # the raise ends the driver run (its run_crash event), the
        # rollback restores and runs again
        "rollback_events": roll[3] == [
            ("nonfinite_step", 5, "rollback"), ("run_crash", None, None),
            ("rollback", 5, None), ("nonfinite_step", 9, "rollback"),
            ("run_crash", None, None), ("rollback", 9, None)],
        "rollback_counters": counters["rollback"].get(
            "resilience/rollbacks") == 2 and counters["rollback"].get(
            "resilience/dispatch_retries") == 1,
        "rollback_completes": int(roll[1].state["neval"]) == n
        and np.isfinite(roll[0][-1]),
        "same_as_cpu_events": all(
            runs[p, device.type][3] == runs[p, "cpu"][3]
            for p in ("skip", "rollback")),
        "within_tol": loss_err <= LENET_TRAIN_TOL,
        "b1_two_a_step": skip[2] == 2 * n,
    }
    print(f"resilience lenet, plan {LENET_PLAN!r}, {n} steps K="
          f"{RESIL['lenet_K']}: skip: skipped {bad}, counters "
          f"{counters['skip']}, flight {skip[3]}; rollback (a snapshot "
          f"every {RESIL['lenet_every']} steps): counters "
          f"{counters['rollback']}, flight {roll[3]}, {len(roll[0])} "
          f"replayed steps, B1 {roll[2]} launches; card vs CPU (skip): "
          f"losses {loss_err:.3e} (tol {LENET_TRAIN_TOL}), step gradients "
          f"by norm share {sound:.3e} (largest {worst}); B1 {skip[2]} "
          f"launches; "
          f"checks "
          + ", ".join(f"{k} {v}" for k, v in checks.items()) + f" [{card}]")
    report["resilience_lenet"] = {
        "checks": checks, "skipped": bad, "counters": counters,
        "events": {p: runs[p, device.type][3] for p in ("skip", "rollback")},
        "loss_err": loss_err, "step_reading": sound, "largest": worst,
        "tol": LENET_TRAIN_TOL, "launches": skip[2]}
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"resilience lenet check failed: {failed}")
    return skip[2]


def elastic_worker(rank, world, store_dir, seed, device_type):
    """One process of the elastic check: LeNet through DistriOptimizer on
    the one card over gloo, batch RESIL["elastic_batch"] a process, a
    snapshot every step, in five runs: uninterrupted, ELASTIC_PLAN sound
    and under each of ELASTIC_FAULTS, and LOSS_PLAN.  Pickles what each
    ends with: the (iteration, loss) of every replayed step, B1's
    launches, the membership history, the metrics, the weights."""
    import pickle
    import torch.distributed as dist
    from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer
    from bigdl_tpu_torch.utils import config
    if device_type == "cuda":
        torch.cuda.set_device(0)
    torch.use_deterministic_algorithms(True)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(store_dir, "store"), world),
        rank=rank, world_size=world)
    B, n = RESIL["elastic_batch"], RESIL["elastic_steps"]
    data = mnist.synthetic_mnist(B * world * 2 * n, seed=0)
    sound_resume = DistriOptimizer._resume_after_resize
    sound_scale = DistriOptimizer._records_scale

    def weights_one_step_early(self, e):
        sound_resume(self, e)
        at = dict(self.state)
        mgr = self._checkpoint_manager()
        mgr.restore_into(self, mgr.path_for(int(at["neval"]) - 1),
                         verified=False)
        self.state.update(at)  # the boundary's counters, older weights

    results = {}
    try:
        for name, plan in (("ref", None), ("elastic", ELASTIC_PLAN),
                           ("weights_one_step_early", ELASTIC_PLAN),
                           ("launch_world_scale", ELASTIC_PLAN),
                           ("device_loss", LOSS_PLAN)):
            if plan is not None:
                config.configure(fault_plan=plan)
            ds = lenet_pipeline(data, True, batch=B, distributed=True)
            if name == "weights_one_step_early":
                DistriOptimizer._resume_after_resize = weights_one_step_early
            elif name == "launch_world_scale":
                DistriOptimizer._records_scale = lambda self: (
                    self._launch_mesh or self.mesh).size
                ds.reshard = lambda index, count: count
            try:
                maxpool.reset_counts()
                opt = distri_optimizer(
                    lenet5(10).initialize(seed + 5), ds, device_type, "f32",
                    1, n, lenet_sgd(), backend="gloo")
                opt._log_train_iteration = lambda lr, o=opt: o.losses.append(
                    (int(o.state["neval"]), o.state["loss"]))
                opt.set_checkpoint(os.path.join(store_dir, f"ck_{name}"),
                                   optim.several_iteration(1))
                opt.optimize()
            finally:
                DistriOptimizer._resume_after_resize = sound_resume
                DistriOptimizer._records_scale = sound_scale
                config.reset_config()
            m = opt._membership
            snap = opt.metrics.registry.snapshot()
            results[name] = {
                "losses": opt.losses,
                "launches": lenet_b1_launches(f"elastic {name}"),
                "worlds": [e.world for e in m.history()] if m else None,
                "neval": int(opt.state["neval"]),
                "steps_lost": snap["counters"].get(
                    "resilience/steps_lost_to_resize"),
                "downtime_s": snap["histograms"].get(
                    "resilience/resize_downtime_s", {}).get("sum"),
                "params": {k: v.detach().cpu().numpy().copy()
                           for k, v in opt.model.named_parameters()}}
        with open(os.path.join(store_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def elastic_reading(run, ref):
    """The largest relative difference of the loss at each iteration (the
    last replay of it) and, per weight array, the largest difference as
    a share of its largest value, of ``run`` against ``ref``."""
    got, want = dict(run["losses"]), dict(ref["losses"])
    loss = max((abs(got[k] - v) / abs(v) if k in got else float("inf"))
               for k, v in want.items())
    params = max(float(np.abs(run["params"][k] - v).max()
                       / np.abs(v).max()) for k, v in ref["params"].items())
    return max(loss, params)


def elastic_phase(seed, device, card, report):
    """LeNet through DistriOptimizer, two processes on the one card over
    gloo: ELASTIC_PLAN gives the membership history [2, 1, 2] with no
    step lost, losses bitwise equal to an uninterrupted world-2 run up to
    the replay boundary and the whole trajectory within ELASTIC_TOL of
    it, a limit both ELASTIC_FAULTS must exceed; LOSS_PLAN resumes from
    the latest valid snapshot at world 1."""
    import pickle
    gen = torch.Generator(device=device).manual_seed(1618)
    for name in DISTRI_POOL_CASES:
        pool_case_check(pool_case(name), gen, device)
    world = 2
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        torch.multiprocessing.spawn(elastic_worker,
                                    args=(world, tmp, seed, device.type),
                                    nprocs=world, join=True)
        wall = time.monotonic() - t0
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    r0 = ranks[0]
    ref, ela, loss = r0["ref"], r0["elastic"], r0["device_loss"]
    n, b = RESIL["elastic_steps"], ELASTIC_BOUNDARY
    sound = elastic_reading(ela, ref)
    faults = {f: elastic_reading(r0[f], ref) for f in ELASTIC_FAULTS}
    checks = {
        "history_2_1_2": all(r["elastic"]["worlds"] == [2, 1, 2]
                             for r in ranks),
        "no_step_lost": ela["steps_lost"] == 0,
        "bitwise_to_boundary": ela["losses"][:b] == ref["losses"][:b]
        and [k for k, _ in ela["losses"]] == list(range(1, n + 1)),
        "within_tol": sound <= ELASTIC_TOL,
        "faults_caught": all(v > ELASTIC_TOL for v in faults.values()),
        "ranks_end_equal": all(
            np.array_equal(r["elastic"]["params"][k], v)
            for r in ranks for k, v in ela["params"].items()),
        "device_loss_resumes": loss["worlds"] == [2, 1]
        and all(r["device_loss"]["neval"] == n for r in ranks)
        and np.isfinite([v for _, v in loss["losses"]]).all(),
    }
    print(f"resilience elastic (LeNet, gloo, two processes on one card, "
          f"batch {RESIL['elastic_batch']} a process, {n} steps, a "
          f"snapshot every step): plan {ELASTIC_PLAN!r}: worlds "
          f"{ela['worlds']}, steps lost {ela['steps_lost']}, resize "
          f"downtime {ela['downtime_s']:.4f} s over 2 resizes; reading "
          f"{sound:.3e}, planted faults "
          + ", ".join(f"{k} {v:.3e}" for k, v in faults.items())
          + f" (tol {ELASTIC_TOL}); {LOSS_PLAN!r}: worlds {loss['worlds']},"
          f" steps lost {loss['steps_lost']}, downtime "
          f"{loss['downtime_s']:.4f} s; B1 launches rank 0 {ela['launches']}"
          f" / rank 1 {ranks[1]['elastic']['launches']}; checks "
          + ", ".join(f"{k} {v}" for k, v in checks.items())
          + f"; {wall:.1f} s [{card}]")
    report["resilience_elastic"] = {
        "checks": checks, "reading": sound, "planted_faults": faults,
        "tol": ELASTIC_TOL, "losses": ela["losses"],
        "ref_losses": ref["losses"], "steps_lost": ela["steps_lost"],
        "downtime_s": ela["downtime_s"], "device_loss": {
            k: loss[k] for k in ("worlds", "steps_lost", "downtime_s",
                                 "losses")}, "wall_s": wall}
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"resilience elastic check failed: {failed}")


def served_gemm_check(model, rows, device):
    """B4 against its plain version at every distinct GEMM of one
    ``rows``-row forward of the quantized ``model`` (weight_only, f32 x):
    (the forward's (M, K, O, bias) list, max abs err)."""
    shapes = gemm_shapes(model, device, batch=rows)
    gen = torch.Generator(device=device).manual_seed(97)
    err = 0.0
    for M, K, O, bias in sorted(set(shapes)):
        xin, wq, scale, b = operands(M, K, O, "float32", bias, gen, device)
        got = int8_gemm.launch(xin, wq, scale, b)
        want = int8_matmul_reference(xin, wq, scale, b)
        torch.testing.assert_close(
            got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item(),
            msg=lambda e: f"B4 weight_only M={M} K={K} O={O}: {e}")
        err = max(err, (got - want).abs().max().item())
    return shapes, err


def serving_faults_phase(seed, device, card, report):
    """The slice-1 int8 ResNet-50 (weight_only) served through
    InferenceService with request tracing and SERVE_PLAN, one request a
    dispatch: dispatch 2's request fails with InjectedFault, dispatch 4
    kills the batcher and ``revive()`` brings it back, every other
    request is bitwise equal to a fault-free service's at the same
    shapes, the trace holds one flow a request, B4 launches 54 a
    forward."""
    from bigdl_tpu_torch.resilience import FaultInjector, InjectedFault
    from bigdl_tpu_torch.serving import InferenceService
    from bigdl_tpu_torch.telemetry import Tracer
    model = quantize(resnet50().initialize(
        torch.Generator().manual_seed(seed)), mode="weight_only")
    rows, n = RESIL["serve_rows"], RESIL["serve_requests"]
    shapes, b4_err = served_gemm_check(copy.deepcopy(model).to(device),
                                       rows, device)
    kw = {"input_spec": SPEC, "max_batch_size": RESIL["serve_max_batch"],
          "batch_timeout_ms": 0, "device": device}
    rng = np.random.default_rng(seed)
    reqs = [rng.normal(0, 1, (rows,) + SPEC[0]).astype(np.float32)
            for _ in range(n)]
    with InferenceService(copy.deepcopy(model), name="clean", **kw) as clean:
        want = [clean.predict(x, timeout=300) for x in reqs]
    tracer = Tracer()
    svc = InferenceService(model, name="faulty", tracer=tracer,
                           request_tracing=True,
                           fault_injector=FaultInjector(SERVE_PLAN), **kw)
    got, outcome = {}, {}
    int8_gemm.reset_counts()
    t0 = time.monotonic()
    try:
        for i, x in enumerate(reqs):
            fut = svc.submit(x)
            if i == 4:
                deadline = time.monotonic() + 60
                while svc.alive and time.monotonic() < deadline:
                    time.sleep(0.005)
                outcome[i] = ("batcher dead" if not svc.alive else "alive",
                              "pending" if not fut.done() else "done")
                outcome["revived"] = svc.revive() and svc.alive
                continue
            try:
                got[i] = fut.result(timeout=300)
                outcome[i] = "ok"
            except InjectedFault as e:
                outcome[i] = f"InjectedFault: {e}"
    finally:
        svc.stop()
    wall = time.monotonic() - t0
    launches = int8_gemm.launches
    stats = svc.stats()
    starts = sorted(e[7] for e in tracer.events() if e[0] == "s")
    ends = sorted(e[7] for e in tracer.events() if e[0] == "f")
    ok = [i for i in range(n) if outcome.get(i) == "ok"]
    checks = {
        "dispatch_2_injected": str(outcome.get(2)).startswith(
            "InjectedFault"),
        "dispatch_4_killed_and_revived": outcome.get(4) == (
            "batcher dead", "pending") and outcome.get("revived") is True,
        "others_bitwise": ok == [0, 1, 3, 5, 6] and all(
            np.array_equal(got[i], want[i]) for i in ok),
        "one_flow_a_request": len(starts) == n and starts == ends,
        "b4_54_a_forward": launches == 54 * len(ok),
        "b4_forward_shapes": len(shapes) == 54,
    }
    print(f"resilience serving (int8 ResNet-50 weight_only, plan "
          f"{SERVE_PLAN!r}, {n} requests of {rows} rows, one a dispatch): "
          + ", ".join(f"{k}: {v}" for k, v in outcome.items())
          + f"; B4 {launches} launches for {len(ok)} forwards, checked "
          f"against its plain version at the {len(set(shapes))} distinct "
          f"GEMMs of a {rows}-row forward (max abs err {b4_err:.3e}); "
          f"requests failed {stats['requests_failed']}; {wall:.1f} s; "
          "checks " + ", ".join(f"{k} {v}" for k, v in checks.items())
          + f" [{card}]")
    report["resilience_serving"] = {"checks": checks, "outcome": {
        str(k): v for k, v in outcome.items()}, "launches": launches,
        "b4_max_abs_err": b4_err, "wall_s": wall}
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"resilience serving check failed: {failed}")
    return launches, shapes


def resilience_phase(seed, device, card, report):
    """PTB-medium under telemetry, LeNet under a fault plan, elastic
    LeNet over two processes, the int8 ResNet-50 served under faults:
    {kernel: launches} and the served forward's GEMM shapes."""
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, fn in (("ptb", ptb_telemetry_phase),
                          ("lenet", lenet_faults_phase)):
            t0 = time.monotonic()
            launches[label] = fn(seed, device, card, report, tmp)
            torch.cuda.empty_cache()
            print(f"phase resilience-{label}: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    elastic_phase(seed, device, card, report)
    print(f"phase resilience-elastic: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    launches["int8_gemm"], shapes = serving_faults_phase(seed, device, card,
                                                         report)
    torch.cuda.empty_cache()
    print(f"phase resilience-serving: {time.monotonic() - t0:.1f} s")
    return launches, shapes


# ---------------------------------------------------------------- interop
INTEROP = {"batch": 32, "serve_threads": 8, "serve_requests": 4,
           "float_requests": 4, "gemms": 54}  # B4 launches a forward
# the Caffe and TensorFlow files hold the same weights in another
# arithmetic (BatchNorm split into BatchNorm + Scale, or folded into one
# scale and shift, the pads as their own nodes): their logits are held
# within this share of max|y| (sound readings ~1e-7 on the card),
# a limit a planted fault must exceed
INTEROP_TOL = {"caffe": 1e-4, "tensorflow": 1e-4}
FILE_FAULT_CONV = 20  # the 3x3 conv whose weights a planted file transposes


def bn_stats_from_seed(model, seed):
    """Every BatchNorm's running statistics, scale and shift drawn from
    ``seed`` (a format that drops one reads as a fault, and Caffe's Scale
    layer does real arithmetic); returns ``model``."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.SpatialBatchNormalization):
                n = m.n_output
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
                m.weight.copy_(1.0 + 0.1 * torch.randn(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
    return model


def resnet50_graph(class_num=1000):
    """ResNet-50's bottlenecks as an ``nn.Graph`` through the functional
    API, in Caffe's ResNet-50 layout: the stem pool is 3x3/2 in ceil mode
    without padding (Caffe pools in ceil mode), the head Flatten and the
    1000-way Linear (the logits)."""
    from bigdl_tpu_torch.nn.initialization import MsraFiller
    inp = nn.Input()

    def conv_bn(x, cin, cout, k, s, p, name):
        x = nn.SpatialConvolution(cin, cout, k, k, s, s, p, p,
                                  with_bias=False, weight_init=MsraFiller(),
                                  name=f"{name}_conv")(x)
        return nn.SpatialBatchNormalization(cout, name=f"{name}_bn")(x)

    h = nn.ReLU(name="stem_relu")(conv_bn(inp, 3, 64, 7, 2, 3, "stem"))
    h = nn.SpatialMaxPooling(3, 3, 2, 2, ceil_mode=True, name="pool1")(h)
    in_c = 64
    for stage, (mid, blocks, stride) in enumerate(
            [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]):
        for bi in range(blocks):
            name, s, out_c = f"res{stage + 2}{'abcdef'[bi]}", \
                stride if bi == 0 else 1, mid * 4
            m = nn.ReLU(name=f"{name}_a_relu")(
                conv_bn(h, in_c, mid, 1, 1, 0, f"{name}_a"))
            m = nn.ReLU(name=f"{name}_b_relu")(
                conv_bn(m, mid, mid, 3, s, 1, f"{name}_b"))
            m = conv_bn(m, mid, out_c, 1, 1, 0, f"{name}_c")
            sc = conv_bn(h, in_c, out_c, 1, s, 0, f"{name}_sc") \
                if s != 1 or in_c != out_c else h
            h = nn.ReLU(name=f"{name}_relu")(
                nn.CAddTable(name=f"{name}_add")([m, sc]))
            in_c = out_c
    h = nn.SpatialAveragePooling(7, 7, 7, 7, name="pool5")(h)
    out = nn.Linear(2048, class_num, name="fc1000")(nn.Flatten(
        name="flatten")(h))
    return nn.Graph([inp], [out], name="ResNet50Graph")


def tensor_rel(y, want) -> float:
    return ((y.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def file_roundtrip(label, save, load, paths, x, device, card, report):
    """Write a model, load it onto the card, run its first forward on
    ``x``: (loaded model, output).  Prints and records the bytes and the
    write, load and first-forward seconds."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    save()
    write_s = time.monotonic() - t0
    size = sum(os.path.getsize(p) for p in paths)
    t0 = time.monotonic()
    model = load().to(device).eval()
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    t0 = time.monotonic()
    with torch.no_grad():
        y = model(x)
    torch.cuda.synchronize()
    fwd_s = time.monotonic() - t0
    print(f"interop {label}: {size} bytes, write {write_s:.2f} s, load "
          f"onto the card {load_s:.2f} s, first forward (batch "
          f"{x.shape[0]}) {fwd_s:.3f} s [{card}]")
    report["interop"]["files"][label] = {
        "bytes": size, "write_s": write_s, "load_s": load_s,
        "first_forward_s": fwd_s}
    return model, y


def transposed_conv_copy(model, index=FILE_FAULT_CONV, kernel=(3, 3)):
    """A copy of ``model`` whose ``index``-th ``kernel`` convolution has
    its kernel transposed (kh <-> kw): the planted file fault."""
    bad = copy.deepcopy(model)
    convs = [m for m in bad.modules() if isinstance(m, nn.SpatialConvolution)
             and m.kernel == kernel]
    w = convs[min(index, len(convs) - 1)].weight
    with torch.no_grad():
        w.copy_(w.transpose(2, 3).contiguous())
    return bad


def held_within(label, fmt, y, want, fault_y, card, report):
    tol = INTEROP_TOL[fmt]
    sound, fault = tensor_rel(y, want), tensor_rel(fault_y, want)
    print(f"interop {label} vs in-memory: max|dy|/max|y| {sound:.3e} "
          f"(limit {tol}); planted fault (one 3x3 conv's kernel transposed "
          f"in the file) {fault:.3e} [{card}]")
    report["interop"]["checks"][label] = {"reading": sound, "limit": tol,
                                          "planted_fault": fault}
    if not (torch.isfinite(y).all() and sound <= tol):
        raise AssertionError(f"interop {label}: reading {sound} over {tol}")
    if not fault > tol:
        raise AssertionError(f"interop {label}: planted fault reads {fault}, "
                             f"inside {tol}: the check is blind")


def bitwise(label, y, want, card, report):
    same = torch.equal(y, want)
    print(f"interop {label} vs in-memory: bitwise {same} [{card}]")
    report["interop"]["checks"][label] = {"bitwise": same}
    if not same:
        raise AssertionError(f"interop {label}: not bitwise, max|dy| "
                             f"{(y - want).abs().max().item()}")


def serve_file_deploy(reg, name, deploy_kw, mem_name, seed, card):
    """8 client threads x 4 requests of 1-4 rows through the file-loaded
    deploy ``name``; every dispatched batch (recorded at the model) then
    replayed through the in-memory quantized deploy ``mem_name`` must give
    the same bits.  Returns the reading (launches, dispatches, stats...)."""
    svc = reg.deploy(name, **deploy_kw)
    batches = []
    hook = svc.model.register_forward_hook(
        lambda m, i, o: batches.append((i[0].clone(), o.clone())))
    errors, got = [], {}

    def client(tid):
        rng = np.random.default_rng(seed * 100 + tid)
        try:
            for r in range(INTEROP["serve_requests"]):
                x = rng.normal(0, 1, (int(rng.integers(1, 5)),)
                               + SPEC[0]).astype(np.float32)
                got[tid, r] = reg.predict(name, x, timeout=300)
        except Exception as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(INTEROP["serve_threads"])]
    int8_gemm.reset_counts()
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.monotonic() - t0
    launches = int8_gemm.launches
    variants = {v: n for v, n in int8_gemm.variant_launches.items() if n}
    hook.remove()
    stats = svc.stats()
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"{name}: client failures: {errors[:3]}")
    rows = sum(len(v) for v in got.values())
    replayed = [reg.predict(mem_name, xb.cpu().numpy(), timeout=300)
                for xb, _ in batches]
    same = all(np.array_equal(yb.cpu().numpy(), r)
               for (_, yb), r in zip(batches, replayed))
    dispatches = stats["dispatch_count"]
    lat = stats["latency_ms"]
    return {"launches": launches, "dispatches": dispatches,
            "variant_launches": variants, "rows": rows, "wall_s": wall,
            "rows_per_s": rows / wall, "p50_ms": lat["p50"],
            "p99_ms": lat["p99"], "bitwise": same,
            "finite": all(np.isfinite(v).all() for v in got.values()),
            "replayed_batches": len(batches)}


def interop_phase(seed, device, card, report):
    """ResNet-50 through ``.bigdl`` and a frozen GraphDef, its Graph twin
    through Caffe and ``.bigdl``, VGG-16 through ``.t7``, Inception v1
    through ``.bigdl``, each loaded onto the card and held against the
    in-memory model; ``convert_model --quantize`` of the ResNet-50 file in
    both modes and the quantized ResNet-50 served from files (B4); the
    Caffe and TF files served in float; a TF while loop on the card
    against the CPU.  Returns {mode: B4 launches of the served loads}."""
    from bigdl_tpu_torch import interop
    from bigdl_tpu_torch.interop import load_tf_graph, save_tf_graph
    report["interop"] = {"files": {}, "checks": {}, "serving": {}}
    B = INTEROP["batch"]
    launches = {}
    repo = os.path.dirname(os.path.abspath(__file__))
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            def at(name):
                return os.path.join(tmp, name)

            # 1. ResNet-50 through .bigdl (bitwise) and a frozen GraphDef
            model = bn_stats_from_seed(resnet50().initialize(
                torch.Generator().manual_seed(seed)), seed + 1)
            model = model.to(device).eval()
            gen = torch.Generator(device=device).manual_seed(seed + 2)
            x = torch.randn((B,) + SPEC[0], generator=gen, device=device)
            with torch.no_grad():
                want = model(x)
            _, y = file_roundtrip(
                "resnet50.bigdl",
                lambda: interop.save_bigdl_module(model, at("r50.bigdl")),
                lambda: interop.load_bigdl_module(at("r50.bigdl")),
                [at("r50.bigdl")], x, device, card, report)
            bitwise("resnet50.bigdl", y, want, card, report)
            shape = (B,) + SPEC[0]
            _, y = file_roundtrip(
                "resnet50.pb",
                lambda: save_tf_graph(model, at("r50.pb"), shape),
                lambda: load_tf_graph(at("r50.pb"), ["input"], ["output"]),
                [at("r50.pb")], x, device, card, report)
            save_tf_graph(transposed_conv_copy(model), at("bad.pb"), shape)
            with torch.no_grad():
                fault_y = load_tf_graph(at("bad.pb"), ["input"], [
                    "output"]).to(device)(x)
            held_within("resnet50.pb", "tensorflow", y, want, fault_y, card,
                        report)
            os.remove(at("bad.pb"))

            # 2. the Graph twin through Caffe and .bigdl
            graph = bn_stats_from_seed(resnet50_graph().initialize(
                torch.Generator().manual_seed(seed + 3)), seed + 4)
            graph = graph.to(device).eval()
            with torch.no_grad():
                want_g = graph(x)
            caffe = [at("r50.prototxt"), at("r50.caffemodel")]
            _, y = file_roundtrip(
                "resnet50_graph.caffe",
                lambda: interop.save_caffe(graph, *caffe),
                lambda: interop.load_caffe_model(*caffe), caffe, x, device,
                card, report)
            bad = [at("bad.prototxt"), at("bad.caffemodel")]
            interop.save_caffe(transposed_conv_copy(graph), *bad)
            with torch.no_grad():
                fault_y = interop.load_caffe_model(*bad).to(device)(x)
            held_within("resnet50_graph.caffe", "caffe", y, want_g, fault_y,
                        card, report)
            for p in bad:
                os.remove(p)
            _, y = file_roundtrip(
                "resnet50_graph.bigdl",
                lambda: interop.save_bigdl_module(graph, at("g.bigdl")),
                lambda: interop.load_bigdl_module(at("g.bigdl")),
                [at("g.bigdl")], x, device, card, report)
            bitwise("resnet50_graph.bigdl", y, want_g, card, report)

            # 3. VGG-16 through .t7, Inception v1 through .bigdl
            for label, build, save, load, fname in (
                    ("vgg16.t7", vgg16, interop.save_torch_module,
                     interop.load_torch_module, "vgg16.t7"),
                    ("inception_v1.bigdl", inception_v1,
                     interop.save_bigdl_module, interop.load_bigdl_module,
                     "inception.bigdl")):
                net = build(1000).initialize(
                    torch.Generator().manual_seed(seed + 5)).to(device).eval()
                with torch.no_grad():
                    want_n = net(x)
                _, y = file_roundtrip(
                    label, lambda: save(net, at(fname)),
                    lambda: load(at(fname)), [at(fname)], x, device, card,
                    report)
                bitwise(label, y, want_n, card, report)
                os.remove(at(fname))
                del net, want_n, y
                torch.cuda.empty_cache()

            # 4. quantized serving from files
            for mode in ("weight_only", "dynamic"):
                t0 = time.monotonic()
                cli = subprocess.run(
                    [sys.executable, "-m",
                     "bigdl_tpu_torch.interop.convert_model", "--from",
                     "bigdl", "--to", "bigdl", "--input", at("r50.bigdl"),
                     "--output", at(f"r50_{mode}.bigdl"), "--quantize",
                     "--quantize-mode", mode, "--device", device.type],
                    cwd=repo, capture_output=True,
                    text=True, timeout=600)
                if cli.returncode != 0:
                    raise AssertionError(f"convert_model --quantize {mode} "
                                         f"failed: {cli.stderr[-2000:]}")
                parity = [line for line in cli.stdout.splitlines()
                          if "quantize parity" in line]
                print(f"interop convert_model --quantize-mode {mode} "
                      f"(subprocess, --device {device.type}): {parity[0]}; "
                      f"{os.path.getsize(at(f'r50_{mode}.bigdl'))} bytes, "
                      f"{time.monotonic() - t0:.1f} s [{card}]")
                report["interop"]["files"][f"resnet50_{mode}.bigdl"] = {
                    "bytes": os.path.getsize(at(f"r50_{mode}.bigdl")),
                    "convert_s": time.monotonic() - t0, "parity": parity[0]}
                kw = {"input_spec": SPEC, "max_batch_size": BATCH}
                with ModelRegistry(device=device) as reg:
                    reg.deploy("mem", model, quantize=mode, **kw)
                    runs = {
                        "quantized_file": serve_file_deploy(
                            reg, "q_file", {
                                "path": at(f"r50_{mode}.bigdl"),
                                "format": "bigdl", **kw}, "mem", seed, card),
                        "quantize_on_deploy": serve_file_deploy(
                            reg, "f_file", {
                                "path": at("r50.bigdl"), "format": "bigdl",
                                "quantize": mode, **kw}, "mem", seed + 1,
                            card)}
                for kind, run in runs.items():
                    print(f"interop serve {mode} {kind}: {run['rows']} rows "
                          f"in {run['dispatches']} dispatches, "
                          f"{run['rows_per_s']:.1f} rows/s, p50 "
                          f"{run['p50_ms']} ms, p99 {run['p99_ms']} ms; B4 "
                          f"{run['launches']} launches "
                          f"({run['variant_launches']}); the "
                          f"{run['replayed_batches']} dispatched batches "
                          f"bitwise through the in-memory deploy: "
                          f"{run['bitwise']} [{card}]")
                    ok = (run["bitwise"] and run["finite"]
                          and run["dispatches"] > 0
                          and run["launches"]
                          == INTEROP["gemms"] * run["dispatches"]
                          and run["replayed_batches"] == run["dispatches"])
                    if not ok:
                        raise AssertionError(f"interop serve {mode} {kind}: "
                                             f"{run}")
                report["interop"]["serving"][mode] = runs
                launches[mode] = {k: r["launches"] for k, r in runs.items()}
                torch.cuda.empty_cache()

            # 5. float serving of the Caffe and TensorFlow files
            for fmt, kw, ref_model in (
                    ("caffe", {"path": caffe[1], "prototxt": caffe[0]},
                     graph),
                    ("tensorflow", {"path": at("r50.pb"),
                                    "tf_inputs": ["input"],
                                    "tf_outputs": ["output"]}, model)):
                rng = np.random.default_rng(seed + 7)
                worst = 0.0
                with ModelRegistry(device=device) as reg:
                    reg.deploy("f", format=fmt, input_spec=SPEC,
                               max_batch_size=BATCH, **kw)
                    for _ in range(INTEROP["float_requests"]):
                        xr = rng.normal(0, 1, (int(rng.integers(1, 5)),)
                                        + SPEC[0]).astype(np.float32)
                        got = torch.from_numpy(reg.predict("f", xr,
                                                           timeout=300))
                        with torch.no_grad():
                            ref_y = ref_model(torch.from_numpy(xr).to(
                                device)).cpu()
                        worst = max(worst, tensor_rel(got, ref_y))
                print(f"interop serve float {fmt}: "
                      f"{INTEROP['float_requests']} requests, max|dy|/max|y| "
                      f"{worst:.3e} (limit {INTEROP_TOL[fmt]}) [{card}]")
                report["interop"]["serving"][f"float_{fmt}"] = worst
                if not worst <= INTEROP_TOL[fmt]:
                    raise AssertionError(f"interop serve float {fmt}: {worst}")

            # 6. a TF while loop on the card against the CPU, bitwise
            sys.path.insert(0, os.path.join(repo, "tests"))
            import torch_tfgraph_util as tg
            with open(at("loop.pb"), "wb") as f:
                f.write(tg.nested_loop_graph())
            loop = load_tf_graph(at("loop.pb"), ["acc0", "w"],
                                 ["out", "i_exit"])
            rng = np.random.default_rng(seed + 8)
            feed = {"acc0": rng.normal(size=(64, 128)).astype(np.float32),
                    "w": rng.normal(size=128).astype(np.float32)}
            cpu = loop({k: torch.from_numpy(v) for k, v in feed.items()})
            on_card = loop.to(device)({k: torch.from_numpy(v).to(device)
                                       for k, v in feed.items()})
            same = all(c.device.type == device.type for c in on_card) \
                and all(torch.equal(a, b.cpu()) for a, b in zip(cpu, on_card))
            print(f"interop TF while loop (two loop variables, a nested "
                  f"frame, 3 x 2 trips over a (64, 128) carry) on the card "
                  f"bitwise the CPU: {same} [{card}]")
            report["interop"]["checks"]["tf_while_loop"] = {"bitwise": same}
            if not same:
                raise AssertionError("interop TF while loop differs")
    finally:
        torch.use_deterministic_algorithms(det)
    return launches


PREDICT = {"lenet_batch": 128, "resnet_images": 32, "resnet_batch": 32,
           "service_threads": 8, "service_requests": 4, "images": 64,
           "image_hw": (280, 320), "image_batch": 32, "fit_images": 4096,
           "fit_epochs": 3, "lr_points": 512, "lr_epochs": 20,
           "mse_points": 256, "mse_epochs": 20}
# card against CPU, each output as a share of the CPU's max|y|: LeNet's
# log-probabilities and the image chain's Inception logits (f32; sound
# readings ~1.4e-7 to 1.9e-7), the int8 ResNet-50 at the served limit
# (SERVE_TOL; weight_only read 6.9e-6 over 100 images); each limit
# between the sound reading and the two planted faults every run measures
# and requires to exceed it (the seeded Inception's logits barely move
# with their input: its faults read ~2e-4)
PREDICT_TOL = {"lenet": 1e-5, "int8": 1e-5, "inception": 1e-5}


def near_ties(logp, k, tol):
    """Rows of ``logp`` whose k-th and (k+1)-th largest scores lie within
    ``tol`` of max|logp| (their top-k set may differ between two sound
    devices)."""
    top = torch.topk(logp, k + 1, dim=-1).values
    gap = top[:, k - 1] - top[:, k]
    return int((gap <= tol * logp.abs().max()).sum())


def predict_reading(y, want):
    """max|y - want| / max|want| of two host arrays."""
    return tensor_rel(torch.as_tensor(y), torch.as_tensor(want))


def held_predictions(label, y, want, faults, tol, card, report):
    """The card's predictions ``y`` against the CPU's ``want`` within
    ``tol`` of max|want|; each of ``faults`` ({name: predictions}) must
    read above it.  Returns the sound reading."""
    sound = predict_reading(y, want)
    readings = {k: predict_reading(v, want) for k, v in faults.items()}
    print(f"predict {label} card vs cpu: max|dy|/max|y| {sound:.3e} (limit "
          f"{tol}); planted faults "
          + ", ".join(f"{k} {v:.3e}" for k, v in readings.items())
          + f" [{card}]")
    report["predict"][label] = {"reading": sound, "limit": tol,
                                "planted_faults": readings}
    if not (np.isfinite(y).all() and y.shape == want.shape
            and sound <= tol):
        raise AssertionError(f"predict {label}: {y.shape} vs {want.shape}, "
                             f"reading {sound} over {tol}")
    for k, v in readings.items():
        if not v > tol:
            raise AssertionError(f"predict {label}: planted fault {k} reads "
                                 f"{v}, inside {tol}: the check is blind")
    return sound


def scaled_copy(model, index, factor=127 / 128):
    """A copy of ``model`` whose child ``index``'s weight is scaled."""
    bad = copy.deepcopy(model)
    with torch.no_grad():
        bad[index].weight.mul_(factor)
    return bad


def scaled_int8_copy(qmodel, index=20, factor=127 / 128):
    """A copy of the quantized ``qmodel`` whose ``index``-th quantized
    convolution has its per-channel weight scales scaled."""
    bad = copy.deepcopy(qmodel)
    convs = [m for m in bad.modules()
             if isinstance(m, QuantizedSpatialConvolution)]
    with torch.no_grad():
        convs[min(index, len(convs) - 1)].weight_scale.mul_(factor)
    return bad


def predict_lenet(seed, device, card, report, tmp):
    """LeNet-5 (seeded) through ``.bigdl``, evaluated by ``Evaluator``
    (Top-1, Top-5, Loss) over the 10,000 validation images at batch 128
    and predicted by ``Predictor``, on the card and on the CPU."""
    from bigdl_tpu_torch import interop
    from bigdl_tpu_torch.optim import Evaluator, Predictor
    path = os.path.join(tmp, "lenet.bigdl")
    interop.save_bigdl_module(lenet5(10).initialize(seed + 11), path)
    model = interop.load_bigdl_module(path)
    cpu_model = copy.deepcopy(model)
    _, val = lenet_data()
    ds = lenet_pipeline(val, False, batch=PREDICT["lenet_batch"])
    methods = [optim.Top1Accuracy(), optim.Top5Accuracy(),
               optim.Loss(nn.ClassNLLCriterion())]
    t0 = time.monotonic()
    got = Evaluator(model, device=device).evaluate(ds, methods)
    eval_s = time.monotonic() - t0
    want = Evaluator(cpu_model, device="cpu").evaluate(ds, methods)
    x = np.concatenate([b.input for b in ds.data(train=False)])
    t0 = time.monotonic()
    y = Predictor(model, batch_size=PREDICT["lenet_batch"],
                  device=device).predict(x)
    predict_s = time.monotonic() - t0
    y_cpu = Predictor(cpu_model, batch_size=PREDICT["lenet_batch"],
                      device="cpu").predict(x)
    tol = PREDICT_TOL["lenet"]
    logp = torch.from_numpy(y_cpu)
    ties = {"Top1Accuracy": near_ties(logp, 1, tol),
            "Top5Accuracy": near_ties(logp, 5, tol)}
    rows = {}
    for name in want:
        g, w = got[name], want[name]
        rows[name] = {"card": g.result, "cpu": w.result,
                      "count": [g.count, w.count]}
        if g.count != w.count:
            raise AssertionError(f"Evaluator {name} counted {g.count} on "
                                 f"the card, {w.count} on the CPU")
        if name in ties:
            if abs(g.value - w.value) > ties[name]:
                raise AssertionError(
                    f"Evaluator {name}: {g.value} hits on the card, "
                    f"{w.value} on the CPU, {ties[name]} near ties")
        elif not abs(g.result - w.result) <= tol * abs(w.result):
            raise AssertionError(f"Evaluator Loss {g.result} on the card, "
                                 f"{w.result} on the CPU")
    faults = {
        "fc1_weight_127_128": Predictor(
            scaled_copy(cpu_model, 8), batch_size=PREDICT["lenet_batch"],
            device=device).predict(x),
        "conv1_kernel_transposed": Predictor(
            transposed_conv_copy(cpu_model, 0, (5, 5)),
            batch_size=PREDICT["lenet_batch"], device=device).predict(x)}
    print(f"predict lenet.bigdl Evaluator over {x.shape[0]} images at batch "
          f"{PREDICT['lenet_batch']} (last batch "
          f"{x.shape[0] % PREDICT['lenet_batch']}): "
          + ", ".join(f"{k} card {v['card']:.6f} cpu {v['cpu']:.6f} "
                      f"({int(v['count'][0])} samples)"
                      for k, v in rows.items())
          + f"; near ties {ties}; Evaluator {eval_s:.2f} s, Predictor "
          f"{predict_s:.2f} s [{card}]")
    report["predict"]["lenet_evaluator"] = rows
    held_predictions("lenet", y, y_cpu, faults, tol, card, report)


def predict_int8_resnet(seed, device, card, report):
    """The int8 ResNet-50 (both modes) predicted by ``Predictor`` over one
    batch of 32 images (``PREDICT["resnet_images"]``: the CPU's reference
    forwards are most of the phase's time), every row against the CPU;
    B4 launches 54 a forward (the row probe's too, when a short batch
    runs it).  Then ``PredictionService`` (weight_only) with 8
    threads x 4 requests of 1-4 rows, each against the CPU.  Returns
    {mode: B4 launches}."""
    from bigdl_tpu_torch.optim import PredictionService, Predictor
    B, n = PREDICT["resnet_batch"], PREDICT["resnet_images"]
    gen = torch.Generator().manual_seed(seed + 12)
    x = torch.randn((n,) + SPEC[0], generator=gen).numpy()
    float_model = resnet50().initialize(seed)
    tol = PREDICT_TOL["int8"]
    launches = {}
    for mode in ("weight_only", "dynamic"):
        qmodel = quantize(float_model, mode=mode)
        cpu_model = copy.deepcopy(qmodel)
        forwards = [0]
        hook = qmodel.register_forward_pre_hook(
            lambda m, i: forwards.__setitem__(0, forwards[0] + 1))
        pred = Predictor(qmodel, batch_size=B, device=device)
        int8_gemm.reset_counts()
        t0 = time.monotonic()
        y = pred.predict(x)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches[mode] = int8_gemm.launches
        hook.remove()
        want = Predictor(cpu_model, batch_size=B, device="cpu").predict(x)
        faults = {
            "conv_kernel_transposed": Predictor(
                quantize(transposed_conv_copy(float_model), mode=mode),
                batch_size=B, device=device).predict(x),
            "conv_scale_127_128": Predictor(
                scaled_int8_copy(cpu_model), batch_size=B,
                device=device).predict(x)}
        print(f"predict int8 resnet50 {mode}: {n} images at batch {B} "
              f"({n // B} batches, a {n % B}-row tail) in "
              f"{wall:.2f} s, {forwards[0]} forwards (the row probe's "
              f"included), B4 {launches[mode]} launches "
              f"({ {v: c for v, c in int8_gemm.variant_launches.items() if c} }) "
              f"[{card}]")
        if launches[mode] != INTEROP["gemms"] * forwards[0]:
            raise AssertionError(f"B4 launched {launches[mode]} times in "
                                 f"{forwards[0]} forwards")
        held_predictions(f"int8_{mode}", y, want, faults, tol, card, report)
        report["predict"][f"int8_{mode}"].update(
            launches=launches[mode], forwards=forwards[0], wall_s=wall)
        del pred, faults
        torch.cuda.empty_cache()

    # PredictionService: concurrent callers coalesced by the engine
    qmodel = quantize(float_model, mode="weight_only")
    cpu_model = copy.deepcopy(qmodel)
    svc = PredictionService(qmodel, batch_size=B, device=device,
                            input_spec=SPEC)
    got, errors = {}, []

    def client(tid):
        rng = np.random.default_rng(seed * 100 + tid)
        try:
            for r in range(PREDICT["service_requests"]):
                xr = rng.normal(0, 1, (int(rng.integers(1, 5)),)
                                + SPEC[0]).astype(np.float32)
                got[tid, r] = (xr, svc.predict(xr))
        except Exception as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(PREDICT["service_threads"])]
    int8_gemm.reset_counts()
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.monotonic() - t0
    service_launches = int8_gemm.launches
    stats = svc.stats()
    svc.stop()
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"PredictionService client failures: "
                           f"{errors[:3]}")
    worst = 0.0
    with torch.no_grad():
        for xr, yr in got.values():
            want = cpu_model(torch.from_numpy(xr))
            worst = max(worst, predict_reading(yr, want.numpy()))
    rows = sum(len(v[0]) for v in got.values())
    print(f"predict PredictionService int8 weight_only: {len(got)} requests "
          f"({rows} rows) from {PREDICT['service_threads']} threads in "
          f"{stats['dispatch_count']} dispatches, {wall:.2f} s, "
          f"request_count {svc.request_count}; B4 {service_launches} "
          f"launches; each request vs the CPU alone: max|dy|/max|y| "
          f"{worst:.3e} (limit {tol}) [{card}]")
    report["predict"]["prediction_service"] = {
        "requests": len(got), "rows": rows, "wall_s": wall,
        "dispatches": stats["dispatch_count"], "reading": worst,
        "limit": tol, "launches": service_launches}
    if not (worst <= tol and svc.request_count == len(got)
            and service_launches == INTEROP["gemms"]
            * stats["dispatch_count"]):
        raise AssertionError(f"PredictionService: reading {worst}, "
                             f"{service_launches} launches in "
                             f"{stats['dispatch_count']} dispatches")
    launches["weight_only"] += service_launches
    return launches


def write_images(folder, n, hw, seed):
    """``n`` seeded RGB PNGs of ``hw`` (h, w) in ``folder``."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    for i in range(n):
        arr = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(folder, f"img_{i:03d}.png"))


def image_chain(folder, bgr=False):
    """The image-classification example's chain over ``folder``: the
    NCHW f32 batch (``bgr``: the channels swapped first, a planted
    fault)."""
    frame = V.ImageFrame.read(folder)
    if bgr:
        frame = frame >> V.ChannelOrder()
    frame = (frame >> V.AspectScale(256) >> V.CenterCrop(224, 224)
             >> V.ChannelNormalize((123.0, 117.0, 104.0),
                                   (58.4, 57.1, 57.4))
             >> V.MatToFloats() >> V.ImageFrameToSample(to_chw=True))
    return np.stack([f["sample"].feature for f in frame.features])


def predict_inception(seed, device, card, report, tmp):
    """Inception v1 (1000 classes, NCHW f32) over 64 PNGs read by
    ``ImageFrame.read`` through the example's chain, at batch 32, against
    the CPU."""
    from bigdl_tpu_torch.optim import Predictor
    folder = os.path.join(tmp, "images")
    write_images(folder, PREDICT["images"], PREDICT["image_hw"], seed + 13)
    t0 = time.monotonic()
    x = image_chain(folder)
    chain_s = time.monotonic() - t0
    model = inception_v1(1000).initialize(seed + 14)
    cpu_model = copy.deepcopy(model)
    B = PREDICT["image_batch"]
    t0 = time.monotonic()
    y = Predictor(model, batch_size=B, device=device).predict(x)
    wall = time.monotonic() - t0
    want = Predictor(cpu_model, batch_size=B, device="cpu").predict(x)
    faults = {
        "conv_kernel_transposed": Predictor(
            transposed_conv_copy(cpu_model), batch_size=B,
            device=device).predict(x),
        "channels_bgr": Predictor(model, batch_size=B, device=device)
        .predict(image_chain(folder, bgr=True))}
    print(f"predict inception_v1 image chain: {x.shape[0]} PNGs of "
          f"{PREDICT['image_hw']} read and transformed to {x.shape[1:]} in "
          f"{chain_s:.2f} s, predicted at batch {B} in {wall:.2f} s "
          f"[{card}]")
    held_predictions("inception_image_chain", y, want, faults,
                     PREDICT_TOL["inception"], card, report)


def mnist_arrays(n):
    """The first ``n`` synthetic MNIST training images, normalized NCHW
    f32, and their labels."""
    (imgs, labels), _ = lenet_data()
    x = ((imgs[:n].reshape(-1, 1, 28, 28).astype(np.float32))
         - mnist.TRAIN_MEAN) / mnist.TRAIN_STD
    return x, labels[:n].astype(np.int32)


def nll_loss(model, x, y):
    """The mean NLL of ``model`` (a CPU copy) over (x, y)."""
    m = copy.deepcopy(model).cpu().eval()
    with torch.no_grad():
        return nn.ClassNLLCriterion().apply(
            m(torch.from_numpy(x)), torch.from_numpy(y)).item()


def predict_estimators(seed, device, card, report):
    """``NNClassifier(lenet5(10))`` fit on 4096 images, 3 epochs at batch
    128 (the estimator example's recipe): the loss falls, B1 2 a step,
    ``transform`` equals the CPU's argmax on the trained weights but at
    near ties; then the logistic regression and the ``NNEstimator`` MSE
    regression of the ML-pipeline example.  Returns B1's launches."""
    from bigdl_tpu_torch.estimator import NNClassifier, NNEstimator
    x, y = mnist_arrays(PREDICT["fit_images"])
    model = lenet5(10).initialize(seed + 15)
    before = nll_loss(model, x, y)
    clf = NNClassifier(model, batch_size=LENET["batch"],
                       max_epoch=PREDICT["fit_epochs"],
                       optim_method=optim.SGD(learning_rate=LENET["lr"],
                                              momentum=LENET["momentum"]),
                       device=device)
    maxpool.reset_counts()
    t0 = time.monotonic()
    fitted = clf.fit(x, y)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = lenet_b1_launches("NNClassifier(lenet5)")
    steps = PREDICT["fit_epochs"] * (len(x) // LENET["batch"])
    after = nll_loss(model, x, y)
    classes = fitted.transform(x)
    with torch.no_grad():
        logp = copy.deepcopy(model).cpu().eval()(torch.from_numpy(x))
    want = logp.argmax(-1).numpy()
    ties = near_ties(logp, 1, PREDICT_TOL["lenet"])
    diff = int((classes != want).sum())
    acc = float((classes == y).mean())
    print(f"predict NNClassifier(lenet5): {steps} steps of batch "
          f"{LENET['batch']} in {wall:.2f} s (fit included): "
          f"ms_per_step={wall / steps * 1e3:.3f} samples_per_s="
          f"{steps * LENET['batch'] / wall:.1f}; NLL {before:.4f} -> "
          f"{after:.4f}; B1 {launches} launches; transform vs CPU argmax: "
          f"{diff} differ ({ties} near ties); train acc {acc:.4f} [{card}]")
    if not (after < before and launches == 2 * steps and diff <= ties):
        raise AssertionError(f"NNClassifier: NLL {before} -> {after}, B1 "
                             f"{launches} in {steps} steps, {diff} classes "
                             f"differ ({ties} near ties)")

    # the ML-pipeline example's two small estimators
    rng = np.random.RandomState(seed)
    xl = rng.rand(PREDICT["lr_points"], 2).astype(np.float32)
    yl = (xl.sum(1) > 1.0).astype(np.int32)
    lr_model = nn.Sequential(nn.Linear(2, 2), nn.LogSoftMax()).initialize(
        seed)
    lr_acc = float((NNClassifier(
        lr_model, batch_size=32, max_epoch=PREDICT["lr_epochs"],
        optim_method=optim.SGD(learning_rate=0.5), device=device)
        .fit(xl, yl).transform(xl) == yl).mean())
    xm = rng.rand(PREDICT["mse_points"], 2).astype(np.float32)
    w = np.asarray([[2.0, -1.0], [0.5, 1.5]], np.float32)
    ym = xm @ w.T + np.asarray([0.1, -0.2], np.float32)
    est = NNEstimator(nn.Linear(2, 2).initialize(seed), nn.MSECriterion(),
                      batch_size=32, max_epoch=PREDICT["mse_epochs"],
                      optim_method=optim.Adam(learning_rate=0.05),
                      device=device)
    mse = float(((est.fit(xm, ym).transform(xm) - ym) ** 2).mean())
    print(f"predict ML pipeline: logistic regression train acc "
          f"{lr_acc:.4f}, NNEstimator MSE regression mse {mse:.6f} [{card}]")
    report["predict"]["estimators"] = {
        "lenet": {"steps": steps, "wall_s": wall, "nll": [before, after],
                  "launches": launches, "differ": diff, "near_ties": ties,
                  "train_acc": acc},
        "logistic_regression_acc": lr_acc, "mse_regression": mse}
    if not (lr_acc > 0.9 and mse < 0.01):
        raise AssertionError(f"ML pipeline estimators: acc {lr_acc}, "
                             f"mse {mse}")
    return launches


def predict_phase(seed, device, card, report):
    """Batch prediction, evaluation and the estimator on the card: LeNet-5
    through ``.bigdl`` (Evaluator, Predictor), the int8 ResNet-50 through
    Predictor and PredictionService (B4), Inception v1 through the image
    chain, NNClassifier and the ML-pipeline estimators (B1).  Returns
    {"int8_gemm": {mode: launches}, "maxpool_bwd": launches}."""
    report["predict"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        predict_lenet(seed, device, card, report, tmp)
        print(f"phase predict-lenet: {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        b4 = predict_int8_resnet(seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase predict-int8: {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        predict_inception(seed, device, card, report, tmp)
        torch.cuda.empty_cache()
        print(f"phase predict-inception: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    b1 = predict_estimators(seed, device, card, report)
    print(f"phase predict-estimators: {time.monotonic() - t0:.1f} s")
    return {"int8_gemm": b4, "maxpool_bwd": b1}


KERAS = {"train": 4096, "val": 1024, "batch": 128, "epochs": 3,
         "check_K": 4, "docs": 4096, "classes": 20, "seq": 200,
         "embed": 100, "hidden": 128, "text_steps": 4, "serve_requests": 4,
         "tf_points": 512, "tf_epochs": 4, "queue_records": 64,
         "queue_epochs": 20}
# the card against the CPU step by step (wd_step_reading): the Keras
# LeNet's K=4 block (LENET_TRAIN_TOL's limit) and one step of each text
# classifier, above the sound readings, below the two planted faults every
# run measures and requires to exceed it (the LSTM's W_t x127/128 reads
# 1.6e-3 on the CPU at these shapes)
KERAS_TOL = {"lenet": 1e-3, "text": 3e-4}
# the deployed Keras JSON LeNet's served log-probabilities against the
# CPU, as a share of max|y| (sound ~1e-7)
KERAS_SERVE_TOL = 1e-5


def keras_lenet():
    """``examples/lenet/train_keras.py``'s model."""
    from bigdl_tpu_torch import keras as K
    return K.Sequential([
        K.Convolution2D(6, 5, 5, activation="tanh", input_shape=(1, 28, 28)),
        K.MaxPooling2D(), K.Convolution2D(12, 5, 5, activation="tanh"),
        K.MaxPooling2D(), K.Flatten(), K.Dense(100, activation="tanh"),
        K.Dense(10, activation="softmax")])


def keras_lenet_json() -> str:
    """The Keras-1.2 ``model.to_json()`` of :func:`keras_lenet`."""
    def layer(cls, **cfg):
        return {"class_name": cls, "config": cfg}
    return json.dumps({"class_name": "Sequential", "config": [
        layer("Convolution2D", name="conv1", nb_filter=6, nb_row=5,
              nb_col=5, activation="tanh", border_mode="valid",
              subsample=[1, 1], dim_ordering="th", bias=True,
              batch_input_shape=[None, 1, 28, 28]),
        layer("MaxPooling2D", name="pool1", pool_size=[2, 2],
              strides=[2, 2], border_mode="valid", dim_ordering="th"),
        layer("Convolution2D", name="conv2", nb_filter=12, nb_row=5,
              nb_col=5, activation="tanh", border_mode="valid",
              subsample=[1, 1], dim_ordering="th", bias=True),
        layer("MaxPooling2D", name="pool2", pool_size=[2, 2],
              strides=[2, 2], border_mode="valid", dim_ordering="th"),
        layer("Flatten", name="flatten"),
        layer("Dense", name="fc1", output_dim=100, activation="tanh",
              bias=True),
        layer("Dense", name="fc2", output_dim=10, activation="softmax",
              bias=True)]})


def keras_weights(core):
    """The Keras-order weight list of a built Keras LeNet's core module:
    conv kernels as they are (``th``), Dense kernels (in, out)."""
    out = []
    for m in core.modules():
        if isinstance(m, nn.SpatialConvolution):
            out += [m.weight.detach().cpu().numpy(),
                    m.bias.detach().cpu().numpy()]
        elif isinstance(m, nn.Linear):
            out += [m.weight.detach().cpu().numpy().T.copy(),
                    m.bias.detach().cpu().numpy()]
    return out


def keras_block(init, batches, criterion, method, device, ctx=None):
    """One block of ``len(batches)`` steps of ``init``'s copy on the card
    through LocalOptimizer over exactly ``batches``, ``method`` recording
    every step: (losses, steps)."""
    K, B = len(batches), batches[0].size()
    with (ctx or contextlib.nullcontext)():
        losses = text_train(
            copy.deepcopy(init), DataSet.array(np.zeros(K * B))
            >> Prebuilt(batches, B), device, optim.max_iteration(K),
            criterion, None, K, method=method)[0]
    return losses, method.steps


def keras_check(label, init, batches, criterion, make_method, faults,
                tol, device, card, report):
    """``init`` through one block on the card against the CPU step by step
    (:func:`wd_step_reading`) within ``tol``; each of ``faults`` ({name:
    (model, context manager factory or None)}) on a card run of its own
    must read above it.  Returns the sound reading."""
    step = text_cpu_step(criterion)
    memo = {}

    def cpu_step(init, params, batch):
        # a fault run from init's weights asks for the sound run's steps
        key = (id(batch), tuple(p.numpy().tobytes().__hash__()
                                for p in params.values()))
        if key not in memo:
            memo[key] = step(init, params, batch)
        return memo[key]

    sound, worst = wd_step_reading(
        *keras_block(init, batches, criterion, make_method(), device), init,
        batches, cpu_step)
    readings = {name: wd_step_reading(
        *keras_block(model, batches, criterion, make_method(), device, ctx),
        init, batches, cpu_step)[0]
        for name, (model, ctx) in faults.items()}
    print(f"keras {label} train-vs-cpu check, {len(batches)} step(s) of "
          f"batch {batches[0].size()} step by step: sound {sound:.3e} "
          f"(largest {worst}), planted faults "
          + ", ".join(f"{k} {v:.3e}" for k, v in readings.items())
          + f" (tol {tol}) [{card}]")
    report["keras"][f"{label}_check"] = {
        "sound": sound, "largest": worst, "planted_faults": readings,
        "tol": tol}
    if not sound <= tol:
        raise AssertionError(f"keras {label} on the card is {sound:.3e} "
                             f"from the CPU, over {tol}")
    for fault, err in readings.items():
        if not err > tol:
            raise AssertionError(f"keras {label}: planted fault {fault} "
                                 f"reads {err:.3e}, inside {tol}: the check "
                                 f"is blind")
    return sound


@contextlib.contextmanager
def b1_fault():
    """B1's first launch of the block returns its result x127/128."""
    sound = maxpool.launch
    maxpool.launch = planted_b1_fault()
    try:
        yield
    finally:
        maxpool.launch = sound


def keras_lenet_phase(seed, device, card, report, tmp):
    """The Keras LeNet of ``examples/lenet/train_keras.py``: compile, fit
    (batch 128, 3 epochs of 4096, validation every epoch), evaluate and
    predict on the card (B1 2 a step); a K=4 block against the CPU step
    by step; then its Keras-1.2 JSON loaded, the trained weights carried
    across in Keras order, deployed from the file and served.  Returns
    B1's launches."""
    from bigdl_tpu_torch.interop.keras_format import (load_keras_json,
                                                      set_keras_weights)
    x, y = mnist_arrays(KERAS["train"])
    vx, vy = x[:KERAS["val"]], y[:KERAS["val"]]
    model = keras_lenet()
    model.compile(optim.SGD(learning_rate=LENET["lr"],
                            momentum=LENET["momentum"]),
                  "categorical_crossentropy", metrics=["accuracy"],
                  device=device)
    core = model.core_module()
    init = copy.deepcopy(core)
    criterion = model.criterion
    before = criterion.apply(init(torch.from_numpy(x[:1024])),
                             torch.from_numpy(y[:1024])).item()
    maxpool.reset_counts()
    t0 = time.monotonic()
    model.fit(x, y, batch_size=KERAS["batch"], nb_epoch=KERAS["epochs"],
              validation_data=(vx, vy))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = lenet_b1_launches("keras lenet")
    steps = KERAS["epochs"] * (len(x) // KERAS["batch"])
    scores = model.evaluate(vx, vy, batch_size=KERAS["batch"])
    probs = model.predict(vx, batch_size=KERAS["batch"])
    classes = model.predict_classes(vx, batch_size=KERAS["batch"])
    with torch.no_grad():
        after = criterion.apply(copy.deepcopy(core).cpu()(
            torch.from_numpy(x[:1024])), torch.from_numpy(y[:1024])).item()
    print(f"keras lenet fit: {steps} steps of batch {KERAS['batch']} in "
          f"{wall:.2f} s (validation every epoch included): ms_per_step="
          f"{wall / steps * 1e3:.3f} samples_per_s="
          f"{steps * KERAS['batch'] / wall:.1f}; loss {before:.4f} -> "
          f"{after:.4f}; last validation {model.optimizer.state.get('score')}"
          f"; evaluate {scores}; predict {probs.shape}, predict_classes "
          f"agree with argmax {bool((classes == probs.argmax(-1)).all())}; "
          f"B1 {launches} launches [{card}]")
    report["keras"]["lenet_fit"] = {
        "steps": steps, "wall_s": wall, "loss": [before, after],
        "evaluate": scores, "launches": launches}
    if not (after < before and launches == 2 * steps
            and np.isfinite(probs).all()
            and probs.shape == (KERAS["val"], 10)
            and (classes == probs.argmax(-1)).all()):
        raise AssertionError(f"keras lenet: loss {before} -> {after}, B1 "
                             f"{launches} in {steps} steps")

    # a K=4 block against the CPU step by step
    K, B = KERAS["check_K"], KERAS["batch"]
    batches = [batch_samples([Sample(x[i], y[i])
                              for i in range(j * B, (j + 1) * B)])
               for j in range(K)]

    def make_sgd():
        return recording(optim.SGD)(learning_rate=LENET["lr"],
                                    momentum=LENET["momentum"])

    fc = copy.deepcopy(init)
    with torch.no_grad():
        fc[5][0].weight.mul_(127 / 128)
    keras_check("lenet", init, batches, criterion, make_sgd,
                {"fc1_weight_127_128": (fc, None),
                 "b1_first_launch_127_128": (init, b1_fault)},
                KERAS_TOL["lenet"], device, card, report)

    # the Keras JSON, the trained weights in Keras order, served
    path = os.path.join(tmp, "lenet.json")
    with open(path, "w") as f:
        f.write(keras_lenet_json())
    weights = keras_weights(core)
    loaded = load_keras_json(path)
    set_keras_weights(loaded, weights)
    trained = copy.deepcopy(core).cpu().eval()
    same = all(torch.equal(a, b.cpu()) for a, b in zip(
        loaded.core_module().state_dict().values(),
        trained.state_dict().values()))
    rng = np.random.default_rng(seed + 16)
    worst = 0.0
    with ModelRegistry(device=device) as reg:
        reg.deploy("keras_lenet", path=path, format="keras", weights=weights,
                   input_spec=((1, 28, 28), np.float32), max_batch_size=32)
        for _ in range(KERAS["serve_requests"]):
            idx = rng.integers(0, len(x), int(rng.integers(1, 5)))
            got = reg.predict("keras_lenet", x[idx], timeout=300)
            with torch.no_grad():
                want = trained(torch.from_numpy(x[idx])).numpy()
            worst = max(worst, predict_reading(got, want))
    print(f"keras lenet JSON: loaded, {len(weights)} Keras-order arrays "
          f"set, weights equal to the trained ones {same}; deployed from "
          f"the file, {KERAS['serve_requests']} requests vs the CPU: "
          f"max|dy|/max|y| {worst:.3e} (limit {KERAS_SERVE_TOL}) [{card}]")
    report["keras"]["json_deploy"] = {"weights_equal": same,
                                      "reading": worst,
                                      "limit": KERAS_SERVE_TOL}
    if not (same and worst <= KERAS_SERVE_TOL):
        raise AssertionError(f"keras JSON deploy: weights equal {same}, "
                             f"reading {worst}")
    return launches


def news_corpus(seed):
    """``synthetic_news(4096, 20)`` tokenized through ``Dictionary`` and
    padded or cut to 200 tokens (ids + 1; 0 pads): (ids, labels, vocab)."""
    from bigdl_tpu_torch.dataset import news20
    texts, labels, _ = news20.synthetic_news(KERAS["docs"],
                                             KERAS["classes"], seed=seed)
    tokens = [t.split() for t in texts]
    d = Dictionary(tokens)
    ids = np.zeros((len(tokens), KERAS["seq"]), np.int32)
    for i, t in enumerate(tokens):
        e = d.encode(t)[:KERAS["seq"]]
        ids[i, :len(e)] = e + 1
    return ids, labels, d.vocab_size() + 1


def keras_text(cell, vocab):
    from bigdl_tpu_torch import keras as K
    rec = K.LSTM if cell == "lstm" else K.GRU
    return K.Sequential([
        K.Embedding(vocab, KERAS["embed"], input_length=KERAS["seq"]),
        K.Bidirectional(rec(KERAS["hidden"])),
        K.Dense(KERAS["classes"], activation="softmax")])


@contextlib.contextmanager
def gru_update_fault():
    """The GRU's new state with the candidate's share x127/128."""
    sound = nn.GRU.step_hoisted

    def step_hoisted(self, zx_t, h, invariants):
        H, D = self.hidden_size, self.input_size
        zg, zc = zx_t[..., :2 * H], zx_t[..., 2 * H:]
        r, u = torch.sigmoid(zg + h @ self.w_gates[:, D:].T).chunk(2, -1)
        cand = torch.tanh(zc + (r * h) @ self.w_cand[:, D:].T)
        h_new = u * h + (1 - u) * cand * (127 / 128)
        return h_new, h_new

    nn.GRU.step_hoisted = step_hoisted
    try:
        yield
    finally:
        nn.GRU.step_hoisted = sound


def keras_text_phase(seed, device, card, report):
    """The two text classifiers over the synthetic news corpus, batch 128:
    a few steps each through ``fit`` (the LSTM's B2f and B2b 400 a step:
    200 steps in each direction), then one step of each against the CPU.
    Returns {kernel: launches}."""
    ids, labels, vocab = news_corpus(seed)
    B, n = KERAS["batch"], KERAS["batch"] * KERAS["text_steps"]
    launches = {}
    for cell in ("lstm", "gru"):
        model = keras_text(cell, vocab)
        model.compile(optim.Adam(learning_rate=1e-3),
                      "categorical_crossentropy", device=device)
        init = copy.deepcopy(model.core_module())
        lstm_cell.fwd_launches = lstm_cell.bwd_launches = 0
        t0 = time.monotonic()
        model.fit(ids[:n], labels[:n], batch_size=B, nb_epoch=1)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        got = {"lstm_cell_fwd": lstm_cell.fwd_launches,
               "lstm_cell_bwd": lstm_cell.bwd_launches}
        steps = KERAS["text_steps"]
        print(f"keras text {cell}: Embedding({vocab}, {KERAS['embed']}) >> "
              f"Bidirectional({cell.upper()}({KERAS['hidden']})) >> "
              f"Dense({KERAS['classes']}), {steps} steps of batch {B} x "
              f"{KERAS['seq']} tokens in {wall:.2f} s (ms_per_step="
              f"{wall / steps * 1e3:.1f}); B2f {got['lstm_cell_fwd']}, B2b "
              f"{got['lstm_cell_bwd']} launches [{card}]")
        want = 2 * KERAS["seq"] * steps if cell == "lstm" else 0
        if got["lstm_cell_fwd"] != want or got["lstm_cell_bwd"] != want:
            raise AssertionError(f"keras text {cell}: B2f/B2b {got}, want "
                                 f"{want} each")
        if cell == "lstm":
            launches = got
        batches = [batch_samples([Sample(ids[i], labels[i])
                                  for i in range(B)])]

        def make_adam():
            return recording(optim.Adam)(learning_rate=1e-3)

        dense = copy.deepcopy(init)
        with torch.no_grad():
            dense[2][0].weight.mul_(127 / 128)
        cell_fault = (("w_t_127_128", (init, lambda: lstm_fault(
            "w_t_127_128"))) if cell == "lstm"
                      else ("gru_update_127_128", (init, gru_update_fault)))
        keras_check(f"text_{cell}", init, batches, model.criterion,
                    make_adam, dict([("dense_weight_127_128", (dense, None)),
                                     cell_fault]),
                    KERAS_TOL["text"], device, card, report)
        report["keras"][f"text_{cell}"] = {"steps": steps, "wall_s": wall,
                                           "launches": got}
    return launches


def keras_tf_session_phase(seed, device, card, report, tmp):
    """``examples/tensorflow/train_imported.py``: a GraphDef saved with
    ``trainable=True``, re-imported and trained by ``TFSession.train`` for
    4 epochs (the loss falls); then the queue-fed form over a TFRecord
    file through ``QueuePipeline``."""
    from bigdl_tpu_torch.dataset import tfrecord
    from bigdl_tpu_torch.interop import save_tf_graph
    from bigdl_tpu_torch.interop.session import TFSession
    model = nn.Sequential(nn.Linear(4, 16), nn.ReLU(), nn.Linear(16, 3),
                          nn.LogSoftMax()).initialize(seed)
    pb = os.path.join(tmp, "model.pb")
    save_tf_graph(model, pb, input_shape=(1, 4), trainable=True)
    rng = np.random.RandomState(seed + 1)
    centers = rng.randn(3, 4) * 3
    yb = rng.randint(0, 3, KERAS["tf_points"])
    xb = (centers[yb] + rng.randn(KERAS["tf_points"], 4)).astype(np.float32)
    ds = (DataSet.array([Sample(a, np.int32(t)) for a, t in zip(xb, yb)])
          >> SampleToMiniBatch(32))
    sess = TFSession(pb, inputs=["input"], outputs=["output"], device=device)
    crit = nn.ClassNLLCriterion()
    before = crit.apply(torch.from_numpy(sess.run(xb)),
                        torch.from_numpy(yb)).item()
    t0 = time.monotonic()
    opt = sess.train(ds, crit, optim_method=optim.Adam(learning_rate=0.05),
                     end_when=optim.max_epoch(KERAS["tf_epochs"]))
    wall = time.monotonic() - t0
    out = sess.run(xb)
    after = crit.apply(torch.from_numpy(out), torch.from_numpy(yb)).item()
    acc = float((out.argmax(1) == yb).mean())
    # queue-fed: the TFRecord pipeline inside the graph
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import torch_tfgraph_util as tg
    true_w = np.float32([1.0, -2.0, 3.0, 0.5])
    qrng = np.random.default_rng(seed)
    recs = []
    for _ in range(KERAS["queue_records"]):
        v = qrng.normal(0, 1, 4).astype(np.float32)
        recs.append(np.concatenate([v, [v @ true_w]]).astype(
            np.float32).tobytes())
    rec_path = os.path.join(tmp, "train.tfrecord")
    tfrecord.write_records(rec_path, recs)
    qpb = os.path.join(tmp, "queue_graph.pb")
    with open(qpb, "wb") as f:
        f.write(tg.build_queue_graph(rec_path))
    qsess = TFSession(qpb, outputs=["loss"], device=device)
    t1 = time.monotonic()
    losses = qsess.train(optim_method=optim.SGD(learning_rate=0.1),
                         epochs=KERAS["queue_epochs"])
    qwall = time.monotonic() - t1
    print(f"keras TFSession: imported GraphDef trained {opt.state['neval']} "
          f"steps in {wall:.2f} s, NLL {before:.4f} -> {after:.4f}, train "
          f"acc {acc:.4f}; queue-fed over {len(recs)} TFRecords: "
          f"{len(losses)} steps (batch {qsess.pipeline.batch_size}) in "
          f"{qwall:.2f} s, loss {losses[0]:.4f} -> {losses[-1]:.3e} "
          f"[{card}]")
    report["keras"]["tf_session"] = {
        "nll": [before, after], "acc": acc, "wall_s": wall,
        "queue_losses": [losses[0], losses[-1]], "queue_steps": len(losses)}
    if not (after < before and losses[-1] < 0.01 * losses[0]
            and all(np.isfinite(losses))):
        raise AssertionError(f"TFSession: NLL {before} -> {after}, queue "
                             f"loss {losses[0]} -> {losses[-1]}")


def keras_phase(seed, device, card, report):
    """The Keras LeNet (fit, evaluate, predict, the K=4 check, JSON
    deploy), the two Keras text classifiers, and TFSession.  Returns
    {"maxpool_bwd": launches, "lstm_cell_fwd"/"lstm_cell_bwd": launches}."""
    report["keras"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        b1 = keras_lenet_phase(seed, device, card, report, tmp)
        print(f"phase keras-lenet: {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        b2 = keras_text_phase(seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase keras-text: {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        keras_tf_session_phase(seed, device, card, report, tmp)
        print(f"phase keras-tf-session: {time.monotonic() - t0:.1f} s")
    return {"maxpool_bwd": b1, **b2}


# the rest of serving over the wire: the front end on both connection
# cores before the registry's two int8 ResNet-50 versions (weight_only
# v1, dynamic v2) and a 2-replica ReplicaSet on cuda:0 (8 clients x 4
# requests of 1-4 rows drawn from a pool of 16 seeded images, JSON and
# npy bodies); a second ReplicaSet under a replica death (8 clients x 6
# requests); the status taxonomy; transformer_lm at its defaults (vocab
# 32000, embed 512, 8 heads, 6 layers, MLP 2048, max_len 2048) decoding
# 16 concurrent streams (prompts 8-200 tokens, 4-64 new ones) in 8 slots
# of max_seq_len 512, prompt buckets pow2@8 up to 256; a hot cutover of
# the decode backend under 8 streaming clients
FRONTEND = {"clients": 8, "requests": 4, "max_rows": 4, "pool_rows": 16,
            "fail_plan": "replica_death@target=0,after=5,count=1",
            "fail_requests": 6, "gen_streams": 16, "prompt": (8, 200),
            "new_tokens": (4, 64), "slots": 8, "max_seq_len": 512,
            "max_prompt_len": 256, "buckets": "pow2@8",
            "cutover_clients": 8, "cutover_tokens": 16}
# the card's decode log-probs (every vocabulary entry at every generated
# position, fed the served tokens) against the CPU's full-context forward
# over the same tokens, and against the card's own full-context forward:
# absolute, f32 through 6 layers in another order on each side (sound
# readings ~1e-5 predicted); three planted faults (wq transposed, the
# write position off by one, the causal cut at < for <=) must exceed it
GEN_TOL = 1e-3


def http_call(port, path, body=None, headers=None, timeout=300):
    """One request to 127.0.0.1:``port`` → (status, headers, raw body)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST" if body is not None else "GET", path,
                     body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def wire_predict(port, target, x, as_json, headers=None):
    """POST ``x`` to ``target``'s predict route as JSON or npy (npy back
    as well) → (status, headers, outputs or the error body)."""
    from io import BytesIO
    hdrs = dict(headers or {})
    if as_json:
        body = json.dumps({"inputs": x.tolist()})
        hdrs["Content-Type"] = "application/json"
    else:
        buf = BytesIO()
        np.save(buf, x)
        body = buf.getvalue()
        hdrs.update({"Content-Type": "application/x-npy",
                     "Accept": "application/x-npy"})
    st, h, raw = http_call(port, f"/v1/models/{target}/predict", body, hdrs)
    if st != 200:
        return st, h, raw
    if "x-npy" in h.get("Content-Type", ""):
        return st, h, np.load(BytesIO(raw))
    return st, h, np.asarray(json.loads(raw)["outputs"], np.float32)


def wire_generate(port, prompt, max_new, timeout=300):
    """POST a generate and read its ndjson stream line by line → (status,
    lines, seconds to the first line, seconds to the end, version)."""
    import http.client
    t0 = time.monotonic()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/v1/models/lm/generate",
                     body=json.dumps({"prompt": [int(t) for t in prompt],
                                      "max_new_tokens": int(max_new)}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            return resp.status, [resp.read()], None, None, None
        lines, ttft = [], None
        while True:
            ln = resp.readline()
            if not ln:
                break
            if ttft is None:
                ttft = time.monotonic() - t0
            lines.append(json.loads(ln))
        return (resp.status, lines, ttft, time.monotonic() - t0,
                int(resp.getheader("X-Model-Version")))
    finally:
        conn.close()


def stream_tokens(lines, max_new):
    """The tokens of one generate stream, or an AssertionError: lines
    0..n-1 in order, closed by a {"done": true} trailer repeating them."""
    if not lines or not lines[-1].get("done"):
        raise AssertionError(f"stream not closed by its trailer: "
                             f"{lines[-1:]}")
    body, trailer = lines[:-1], lines[-1]
    if [ln.get("index") for ln in body] != list(range(len(body))):
        raise AssertionError("stream out of order")
    toks = [ln["token"] for ln in body]
    if toks != trailer["tokens"] or len(toks) != max_new:
        raise AssertionError(f"stream of {len(toks)} tokens, trailer "
                             f"{trailer.get('n')}, asked {max_new}")
    return toks


def pct_ms(xs, q):
    return round(float(np.percentile(np.asarray(xs) * 1e3, q)), 3)


class BlockingNet(torch.nn.Module):
    """A forward that waits for ``release``: holds one dispatch on the
    card so the queue behind it fills (the 429 check)."""

    def __init__(self):
        super().__init__()
        self.entered, self.release = threading.Event(), threading.Event()
        self.release.set()

    def forward(self, x):
        self.entered.set()
        if not self.release.wait(120):
            raise RuntimeError("BlockingNet was never released")
        return x * 1.0


def teacher_forced(model, prompt, toks, device):
    """Log-prob rows (n, V) of the decode carry on ``device`` fed the
    served tokens: the prefill's last row, then one step a token."""
    from bigdl_tpu_torch.models.transformer import (
        init_kv_cache, splice_kv, transformer_lm_decode_step,
        transformer_lm_prefill)
    p = torch.tensor(prompt, device=device)[None]
    n0 = p.shape[1]
    with torch.inference_mode():
        lp, kp, vp = transformer_lm_prefill(model, p)
        k, v = init_kv_cache(model, 1, n0 + len(toks), device=device)
        splice_kv(k, kp, 0)  # a head-split model's cache part by part
        splice_kv(v, vp, 0)
        rows = [lp[0, -1]]
        for i, t in enumerate(toks[:-1]):
            lp1, k, v = transformer_lm_decode_step(
                model, torch.tensor([t], device=device),
                torch.tensor([n0 + i], device=device), k, v)
            rows.append(lp1[0])
        return torch.stack(rows).float().cpu()


def full_context(model, prompt, toks, device):
    """Log-prob rows (n, V) of one full-context forward over prompt +
    tokens, at the positions that predicted each token."""
    seq = torch.tensor(list(prompt) + list(toks), device=device)[None]
    with torch.inference_mode():
        lp = model(seq)[0]
    n0 = len(prompt)
    return lp[n0 - 1:n0 - 1 + len(toks)].float().cpu()


def swap_shard_halves(shards):
    """Slices 0 and 1 of a tensor-parallel weight exchanged (a planted
    fault; a second call undoes it)."""
    with torch.no_grad():
        a = shards[0].detach().clone()
        shards[0].copy_(shards[1])
        shards[1].copy_(a)


def planted_decode_faults(model, prompt, toks, want, device):
    """{fault: the teacher-forced reading against ``want`` with that fault
    planted in the card's decode carry}; a sharded model's weight fault
    swaps two slices of ``wq`` where an unsharded one's transposes it."""
    from bigdl_tpu_torch.models import transformer as tr
    from bigdl_tpu_torch.parallel.tensor_parallel import Shards
    out = {}
    write, softmax = tr.write_kv, tr.masked_softmax
    mha = model[2][0][0][0][1]
    sharded = isinstance(mha.wq, Shards)
    w_fault = "wq_halves_swapped" if sharded else "wq_transposed"
    for fault in (w_fault, "position_off_by_one", "causal_strict"):
        try:
            if fault == "wq_halves_swapped":
                swap_shard_halves(mha.wq)
            elif fault == "wq_transposed":
                with torch.no_grad():
                    mha.wq.copy_(mha.wq.T.clone())
            elif fault == "position_off_by_one":
                tr.write_kv = lambda c, n, s: write(c, n, s + 1)
            else:  # ki < p for ki <= p: each row loses its last key
                tr.masked_softmax = lambda s, keep: softmax(
                    s, keep & torch.roll(keep, -1, -1))
            got = teacher_forced(model, prompt, toks, device)
            out[fault] = float((got - want).abs().max())
        finally:
            tr.write_kv, tr.masked_softmax = write, softmax
            if fault == "wq_halves_swapped":
                swap_shard_halves(mha.wq)
            elif fault == "wq_transposed":
                with torch.no_grad():
                    mha.wq.copy_(mha.wq.T.clone())
    return out


def frontend_predict_check(fe_ports, services, pool, want_wo, dyn_want,
                           seed, card, report):
    """Check 1: the wire predict on both cores.  Returns the B4 launches
    by mode."""
    wo_svcs, dyn_svc = services
    targets = ("resnet50:1", "resnet50:2", "rs")
    out = {"weight_only": 0, "dynamic": 0}
    for core, port in fe_ports.items():
        before = {id(s): s.stats()["dispatch_count"]
                  for s in wo_svcs + [dyn_svc]}
        int8_gemm.reset_counts()
        results, errors, lat = [], [], []
        dyn_lock = threading.Lock()  # a dynamic request goes alone

        def client(tid):
            rng = np.random.default_rng(seed * 1000 + tid)
            try:
                for r in range(FRONTEND["requests"]):
                    target = targets[(tid + r) % 3]
                    n = int(rng.integers(1, FRONTEND["max_rows"] + 1))
                    idx = tuple(int(i) for i in rng.choice(
                        FRONTEND["pool_rows"], n, replace=False))
                    as_json = r == 0 and tid % 2 == 0
                    gate = dyn_lock if target.endswith(":2") \
                        else contextlib.nullcontext()
                    with gate:
                        t0 = time.monotonic()
                        st, _h, y = wire_predict(port, target, pool[list(idx)],
                                                 as_json)
                        lat.append((time.monotonic() - t0, as_json))
                    results.append((target, idx, st, y, as_json))
            except Exception as e:  # re-raised below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(FRONTEND["clients"])]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.monotonic() - t0
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError(f"wire predict {core}: {errors[:3]}")
        bad = [(tg, st) for tg, _i, st, _y, _j in results if st != 200]
        if bad or len(results) != FRONTEND["clients"] * FRONTEND["requests"]:
            raise AssertionError(f"wire predict {core}: {bad[:4]}")
        launches = {m: sum(n for v, n in int8_gemm.variant_launches.items()
                           if v.endswith(m)) for m in out}
        disp = {"weight_only": sum(s.stats()["dispatch_count"] - before[id(s)]
                                   for s in wo_svcs),
                "dynamic": dyn_svc.stats()["dispatch_count"]
                - before[id(dyn_svc)]}
        worst = {"weight_only": 0.0, "dynamic": 0.0}
        for target, idx, _st, y, _j in results:
            mode = "dynamic" if target.endswith(":2") else "weight_only"
            want = dyn_want(idx) if mode == "dynamic" else want_wo[list(idx)]
            worst[mode] = max(worst[mode], rel_err(y, want))
        rows = sum(len(i) for _t, i, *_ in results)
        npy = [t for t, j in lat if not j]
        lat = [t for t, _j in lat]
        print(f"frontend wire predict {core}: {len(results)} requests "
              f"({rows} rows; {sum(j for *_, j in results)} JSON, the rest "
              f"npy) from {FRONTEND['clients']} clients to v1 weight_only, "
              f"v2 dynamic and a 2-replica set on cuda:0 in {wall:.2f} s: "
              f"{rows / wall:.1f} rows/s, p50 {pct_ms(lat, 50)} ms, p99 "
              f"{pct_ms(lat, 99)} ms (npy bodies alone p50 "
              f"{pct_ms(npy, 50)} ms, p99 {pct_ms(npy, 99)} ms); every row "
              f"against the CPU: "
              f"weight_only {worst['weight_only']:.3e}, dynamic "
              f"{worst['dynamic']:.3e} of max|y| (limit "
              f"{SERVE_TOL['weight_only']}); B4 {launches} launches for "
              f"{disp} dispatches [{card}]")
        for mode in out:
            if launches[mode] != INTEROP["gemms"] * disp[mode] \
                    or not disp[mode]:
                raise AssertionError(f"wire {core} {mode}: B4 "
                                     f"{launches[mode]} launches for "
                                     f"{disp[mode]} dispatches")
            if not worst[mode] <= SERVE_TOL[mode]:
                raise AssertionError(f"wire {core} {mode}: rows "
                                     f"{worst[mode]:.3e} from the CPU")
            out[mode] += launches[mode]
        report["frontend"][f"predict_{core}"] = {
            "requests": len(results), "rows": rows, "wall_s": wall,
            "rows_per_s": rows / wall, "p50_ms": pct_ms(lat, 50),
            "p99_ms": pct_ms(lat, 99), "npy_p50_ms": pct_ms(npy, 50),
            "npy_p99_ms": pct_ms(npy, 99), "reading": worst,
            "launches": launches, "dispatches": disp}
    return out


def frontend_failover_check(port, rs_f, flight, pool, want_wo, seed, card,
                            report):
    """Check 2: a replica death under wire load.  Returns B4 launches."""
    before = [r.stats()["dispatch_count"] for r in rs_f._replicas]
    int8_gemm.reset_counts()
    results, errors = [], []

    def client(tid):
        rng = np.random.default_rng(seed * 2000 + tid)
        try:
            for _ in range(FRONTEND["fail_requests"]):
                n = int(rng.integers(1, FRONTEND["max_rows"] + 1))
                idx = [int(i) for i in rng.choice(FRONTEND["pool_rows"], n,
                                                  replace=False)]
                t0 = time.monotonic()
                st, h, y = wire_predict(port, "failover", pool[idx], False)
                results.append((st, h.get("X-Trace-Id"), idx, y,
                                time.monotonic() - t0))
        except Exception as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(FRONTEND["clients"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"failover clients: {errors[:3]}")
    want_n = FRONTEND["clients"] * FRONTEND["fail_requests"]
    if len(results) != want_n or any(r[0] != 200 for r in results):
        raise AssertionError(f"failover: {len(results)} of {want_n} "
                             f"answered, statuses "
                             f"{sorted({r[0] for r in results})}")
    worst = max(rel_err(y, want_wo[idx]) for _s, _t, idx, y, _l in results)
    counts, res = flight.counts(), rs_f.stats()["resilience"]
    events = flight.events()
    victims = {e.get("trace_id") for e in events
               if e["event"] == "failover"}
    death = next(e for e in events if e["event"] == "replica_death")
    revival = next(e for e in events if e["event"] == "revival")
    victim_lat = [lat for _s, t, _i, _y, lat in results if t in victims]
    all_lat = [r[4] for r in results]
    launches = int8_gemm.launches
    disp = sum(r.stats()["dispatch_count"] - b
               for r, b in zip(rs_f._replicas, before))
    print(f"frontend failover ({FRONTEND['fail_plan']}): {len(results)} "
          f"requests, all 200, rows {worst:.3e} of max|y| from the CPU; "
          f"flight {dict(counts)}; counters deaths "
          f"{res['resilience/replica_deaths']}, failovers "
          f"{res['resilience/failovers']}, revivals "
          f"{res['resilience/revivals']}, quarantines "
          f"{res['resilience/quarantines']}; death to revival "
          f"{(revival['t_unix'] - death['t_unix']) * 1e3:.3f} ms; "
          f"{len(victim_lat)} failed-over request(s) answered in "
          f"{[round(x * 1e3, 3) for x in victim_lat]} ms against p50 "
          f"{pct_ms(all_lat, 50)} ms; B4 {launches} launches for {disp} "
          f"dispatches [{card}]")
    if not (counts.get("replica_death") == 1 == counts.get("revival")
            and counts.get("failover", 0) >= 1
            and res["resilience/replica_deaths"] == 1
            and res["resilience/revivals"] == 1
            and res["resilience/failovers"] == counts["failover"]
            and victim_lat and worst <= SERVE_TOL["weight_only"]
            and launches == INTEROP["gemms"] * disp):
        raise AssertionError(f"failover story: flight {counts}, counters "
                             f"{res}, rows {worst}")
    report["frontend"]["failover"] = {
        "flight": dict(counts), "counters": res, "reading": worst,
        "death_to_revival_ms": (revival["t_unix"] - death["t_unix"]) * 1e3,
        "victim_ms": [x * 1e3 for x in victim_lat],
        "p50_ms": pct_ms(all_lat, 50), "launches": launches}
    return launches


def frontend_taxonomy_check(port, slow, slow_net, card, report):
    """Check 3: 504 past a queued deadline, 429 with Retry-After on a
    full queue, 404 for an unknown model."""
    row = np.ones((1, 4), np.float32)
    st504, _h, _b = wire_predict(port, "parked", row, True,
                                 {"X-Deadline-Ms": "100"})
    slow.predict(row, timeout=60)  # a dispatch: the drain rate is known
    slow_net.release.clear()
    slow_net.entered.clear()
    held = slow.submit(row)  # dispatched, waits in the forward
    if not slow_net.entered.wait(60):
        raise AssertionError("the held dispatch never started")
    queued = slow.submit(row)  # fills the one-request queue
    try:
        st429, h429, b429 = wire_predict(port, "slow", row, True)
    finally:
        slow_net.release.set()
    held.result(60), queued.result(60)
    st404, _h, _b = wire_predict(port, "nope", row, True)
    print(f"frontend taxonomy: deadline 100 ms while queued -> {st504}; "
          f"full queue -> {st429} Retry-After {h429.get('Retry-After')} "
          f"X-Retry-After-Ms {h429.get('X-Retry-After-Ms')}; unknown model "
          f"-> {st404} [{card}]")
    if (st504, st429, st404) != (504, 429, 404) \
            or "Retry-After" not in h429:
        raise AssertionError(f"taxonomy {(st504, st429, st404)} {h429}")
    report["frontend"]["taxonomy"] = {"deadline": st504, "full": st429,
                                      "retry_after": h429["Retry-After"],
                                      "unknown": st404}


def decode_step_alone(model, dec, card):
    """One decode step over the service's slot batch, alone on an idle
    card (a fresh cache, every slot at position 300): event-timed ms a
    step, and the device ms of its kernels (torch.profiler)."""
    from bigdl_tpu_torch.models.transformer import (
        init_kv_cache, transformer_lm_decode_step)
    k, v = init_kv_cache(model, dec.slots, dec.max_seq_len, dec.device)
    toks = torch.zeros(dec.slots, dtype=torch.int64, device=dec.device)
    lens = torch.full((dec.slots,), 300, dtype=torch.int64,
                      device=dec.device)

    def step():
        with torch.inference_mode():
            transformer_lm_decode_step(model, toks, lens, k, v)

    out = {"event_ms": cuda_ms(step), "device_ms": device_ms(step, 20)}
    print(f"frontend decode step alone ({dec.slots} slots at position "
          f"300 of {dec.max_seq_len}): {out['event_ms']:.3f} ms a step "
          f"(events), {out['device_ms']:.3f} ms of device work [{card}]")
    del k, v
    return out


def frontend_generate_check(fe_ports, dec, lm_cpu, seed, card, report):
    """Check 4: 16 concurrent streams over both cores, each in order and
    closed by its trailer; the served tokens teacher-forced through the
    card's decode carry against the CPU's full-context forward and the
    card's own, within GEN_TOL; three planted faults above it."""
    rng = np.random.default_rng(seed + 77)
    V = lm_cpu[0].n_index
    jobs = [(rng.integers(0, V, int(rng.integers(FRONTEND["prompt"][0],
                                                 FRONTEND["prompt"][1] + 1)))
             .tolist(), int(rng.integers(FRONTEND["new_tokens"][0],
                                         FRONTEND["new_tokens"][1] + 1)))
            for _ in range(FRONTEND["gen_streams"])]
    ports = list(fe_ports.values())
    warm, steps0 = dec.compile_count, dec.steps_done
    results, errors = {}, []
    start = threading.Barrier(len(jobs))

    def client(i):
        try:
            start.wait(60)
            results[i] = wire_generate(ports[i % len(ports)], *jobs[i])
        except Exception as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(jobs))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.monotonic() - t0
    if errors or len(results) != len(jobs):
        raise RuntimeError(f"generate clients: {errors[:3]}")
    served = []
    for i, (prompt, max_new) in enumerate(jobs):
        st, lines, _tt, _w, _v = results[i]
        if st != 200:
            raise AssertionError(f"generate {i}: {st} {lines}")
        served.append(stream_tokens(lines, max_new))
    steps = dec.steps_done - steps0
    stats = dec.stats()
    if dec.compile_count != warm:
        raise AssertionError("the decode service warmed again")
    n_tok = sum(len(t) for t in served)
    ttft = [results[i][2] for i in range(len(jobs))]
    model = dec._model
    reading = {"vs_cpu": 0.0, "vs_card_full": 0.0}
    ties = 0
    for (prompt, _m), toks in zip(jobs, served):
        inc = teacher_forced(model, prompt, toks, dec.device)
        cpu = full_context(lm_cpu, prompt, toks, "cpu")
        card_full = full_context(model, prompt, toks, dec.device)
        reading["vs_cpu"] = max(reading["vs_cpu"],
                                float((inc - cpu).abs().max()))
        reading["vs_card_full"] = max(reading["vs_card_full"],
                                      float((inc - card_full).abs().max()))
        top2 = cpu.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * GEN_TOL
        ties += int((~clear).sum())
        if not torch.equal(cpu.argmax(-1)[clear],
                           torch.tensor(toks)[clear]):
            raise AssertionError("a served token is not the CPU's argmax "
                                 "at a clear margin")
    alone = decode_step_alone(model, dec, card)
    prompt, _m = jobs[0]
    want = full_context(lm_cpu, prompt, served[0], "cpu")
    faults = planted_decode_faults(model, prompt, served[0], want,
                                   dec.device)
    d = stats["decode"]
    print(f"frontend generate: {len(jobs)} concurrent streams (prompts "
          f"{min(len(j[0]) for j in jobs)}-{max(len(j[0]) for j in jobs)} "
          f"tokens, {n_tok} new) over both cores in {wall:.2f} s: "
          f"{n_tok / wall:.1f} tokens/s, {steps} steps, "
          f"{wall / max(steps, 1) * 1e3:.3f} ms a step of wall "
          f"(step_ms_ewma {d['step_ms_ewma']}), occupancy "
          f"{d['step_occupancy']}; time to first token p50 "
          f"{pct_ms(ttft, 50)} ms p99 {pct_ms(ttft, 99)} ms; KV cache "
          f"{dec.kv_bytes} bytes ({dec.slots} slots x {dec.max_seq_len}); "
          f"compile_count {dec.compile_count} [{card}]")
    print(f"frontend generate check: the card's decode log-probs vs the "
          f"CPU's full context {reading['vs_cpu']:.3e}, vs the card's full "
          f"context {reading['vs_card_full']:.3e} (limit {GEN_TOL}); every "
          f"token the CPU's argmax but at {ties} near ties; planted faults "
          + ", ".join(f"{k} {v:.3e}" for k, v in faults.items())
          + f" [{card}]")
    if not (max(reading.values()) <= GEN_TOL
            and min(faults.values()) > GEN_TOL):
        raise AssertionError(f"generate check {reading} {faults}")
    report["frontend"]["generate"] = {
        "streams": len(jobs), "tokens": n_tok, "wall_s": wall,
        "tokens_per_s": n_tok / wall, "steps": steps,
        "step_ms_wall": wall / max(steps, 1) * 1e3,
        "step_ms_ewma": d["step_ms_ewma"], "occupancy": d["step_occupancy"],
        "ttft_p50_ms": pct_ms(ttft, 50), "ttft_p99_ms": pct_ms(ttft, 99),
        "kv_bytes": dec.kv_bytes, "reading": reading, "near_ties": ties,
        "faults": faults, "step_alone": alone}


def frontend_cutover_check(port, reg, fe, lm_gpu, seed, device, card,
                           report):
    """Check 5: a hot cutover of the decode backend under 8 streaming
    clients: no stream dropped, both versions served."""
    from bigdl_tpu_torch.frontend import HotCutover
    from bigdl_tpu_torch.serving import DecodeService
    stop, done, errors = threading.Event(), [], []
    n_new = FRONTEND["cutover_tokens"]

    def client(tid):
        rng = np.random.default_rng(seed * 3000 + tid)
        try:
            while not stop.is_set():
                prompt = rng.integers(0, lm_gpu[0].n_index,
                                      int(rng.integers(8, 64)))
                st, lines, _t, _w, ver = wire_generate(port, prompt, n_new)
                if st != 200:
                    raise AssertionError(f"cutover stream {st} {lines}")
                stream_tokens(lines, n_new)
                done.append(ver)
        except Exception as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(FRONTEND["cutover_clients"])]
    for t in threads:
        t.start()
    try:
        deadline = time.monotonic() + 120
        while len(done) < 8 and time.monotonic() < deadline and not errors:
            time.sleep(0.01)
        t0 = time.monotonic()
        rep = HotCutover(reg, fe, drain_timeout_s=120).deploy(
            "lm", service=DecodeService(
                lm_gpu, slots=FRONTEND["slots"],
                max_seq_len=FRONTEND["max_seq_len"],
                max_prompt_len=FRONTEND["max_prompt_len"],
                prefill_buckets=FRONTEND["buckets"], device=device,
                name="lm-v2"))
        cut_s = time.monotonic() - t0
        n = len(done)
        while len(done) < n + 8 and time.monotonic() < deadline + 120 \
                and not errors:
            time.sleep(0.01)
    finally:
        stop.set()
        for t in threads:
            t.join(300)
    versions = sorted(set(done))
    print(f"frontend hot cutover under {FRONTEND['cutover_clients']} "
          f"streaming clients: v{rep['old_version']} -> "
          f"v{rep['new_version']} in {cut_s:.2f} s (warmup "
          f"{rep['warmup_s']} s, wire drain {rep['wire_drain_s']} s), "
          f"{len(done)} streams of {n_new} tokens, versions {versions}, "
          f"{len(errors)} dropped [{card}]")
    if errors or versions != [1, 2] or not rep["old_undeployed"]:
        raise AssertionError(f"cutover: {errors[:3]} {versions} {rep}")
    report["frontend"]["cutover"] = {"streams": len(done),
                                     "versions": versions,
                                     "cut_s": cut_s, **rep}


def frontend_phase(seed, device, card, report):
    """The wire front end, the replica set and the decode engine on the
    card (FRONTEND).  Returns {mode: B4 launches}."""
    from bigdl_tpu_torch.frontend import FrontendServer
    from bigdl_tpu_torch.models import transformer_lm
    from bigdl_tpu_torch.resilience import FaultInjector, ReplicaSet
    from bigdl_tpu_torch.serving import DecodeService, InferenceService
    from bigdl_tpu_torch.telemetry.flight import FlightRecorder
    report["frontend"] = {}
    # both replica sets put their two replicas on the one card
    card0 = torch.device("cuda", 0) if device.type == "cuda" else device
    model = resnet50().initialize(torch.Generator().manual_seed(seed))
    qwo = quantize(model, mode="weight_only")
    qdyn_cpu = quantize(model, mode="dynamic")
    gen = torch.Generator().manual_seed(seed + 31)
    pool = torch.randn((FRONTEND["pool_rows"],) + SPEC[0],
                       generator=gen).numpy()
    t0 = time.monotonic()
    with torch.inference_mode():
        want_wo = np.concatenate([qwo(torch.from_numpy(pool[i:i + 4]))
                                  .numpy() for i in range(0, len(pool), 4)])
    dyn_cache = {}

    def dyn_want(idx):  # a lone dynamic request's CPU twin
        if idx not in dyn_cache:
            with torch.inference_mode():
                dyn_cache[idx] = qdyn_cpu(torch.from_numpy(
                    pool[list(idx)])).numpy()
        return dyn_cache[idx]

    print(f"frontend cpu references: the {len(pool)} pool images "
          f"(weight_only) in {time.monotonic() - t0:.1f} s")
    tmp = tempfile.mkdtemp(prefix="frontend-")
    flight = FlightRecorder(os.path.join(tmp, "flight.jsonl"))
    reg = ModelRegistry(device=device)
    owned, servers = [], {}
    try:
        v1 = reg.deploy("resnet50", model, input_spec=SPEC,
                        max_batch_size=BATCH, quantize=True)
        v2 = reg.deploy("resnet50", model, input_spec=SPEC,
                        max_batch_size=BATCH, quantize="dynamic")
        rs = ReplicaSet(qwo, n_replicas=2, devices=[card0], input_spec=SPEC,
                        max_batch_size=BATCH, name="rs")
        owned.append(rs)
        rs_f = ReplicaSet(qwo, n_replicas=2, devices=[card0],
                          input_spec=SPEC, max_batch_size=BATCH,
                          name="failover", flight=flight,
                          request_tracing=True, fault_injector=FaultInjector(
                              FRONTEND["fail_plan"], seed=seed))
        owned.append(rs_f)
        parked = InferenceService(BlockingNet(), input_spec=((4,),
                                                             np.float32),
                                  max_batch_size=1, buckets="1",
                                  start=False, device=device, name="parked")
        slow_net = BlockingNet()
        slow = InferenceService(slow_net, input_spec=((4,), np.float32),
                                max_batch_size=1, buckets="1",
                                queue_capacity=1, device=device, name="slow")
        owned += [parked, slow]
        lm = transformer_lm().initialize(seed).eval()
        lm_cpu = copy.deepcopy(lm)
        t0 = time.monotonic()
        dec = DecodeService(lm, slots=FRONTEND["slots"],
                            max_seq_len=FRONTEND["max_seq_len"],
                            max_prompt_len=FRONTEND["max_prompt_len"],
                            prefill_buckets=FRONTEND["buckets"],
                            device=device, name="lm")
        n_params = sum(p.numel() for p in lm.parameters())
        print(f"frontend decode service: transformer_lm {n_params} "
              f"parameters, slots {dec.slots}, max_seq_len "
              f"{dec.max_seq_len}, prompt buckets {list(dec.buckets)}, "
              f"KV cache {dec.kv_bytes} bytes, warmup "
              f"{time.monotonic() - t0:.2f} s ({dec.compile_count} runs) "
              f"[{card}]")
        reg.deploy("lm", service=dec)
        backends = {"rs": rs, "failover": rs_f, "parked": parked,
                    "slow": slow}
        for core in ("eventloop", "threaded"):
            servers[core] = FrontendServer(reg, backends=backends, port=0,
                                           core=core)
            servers[core].start()
        ports = {c: s.port for c, s in servers.items()}

        t0 = time.monotonic()
        launches = frontend_predict_check(
            ports, ([v1, *rs._replicas], v2), pool, want_wo, dyn_want,
            seed, card, report)
        print(f"phase frontend-predict: {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        launches["weight_only"] += frontend_failover_check(
            ports["eventloop"], rs_f, flight, pool, want_wo, seed, card,
            report)
        print(f"phase frontend-failover: {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        frontend_taxonomy_check(ports["threaded"], slow, slow_net, card,
                                report)
        print(f"phase frontend-taxonomy: {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        frontend_generate_check(ports, dec, lm_cpu, seed, card, report)
        print(f"phase frontend-generate: {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        frontend_cutover_check(ports["eventloop"], reg,
                               servers["eventloop"], lm, seed, device, card,
                               report)
        print(f"phase frontend-cutover: {time.monotonic() - t0:.1f} s")
    finally:
        for s in servers.values():
            s.stop()
        for b in owned:
            b.stop(drain=False)
        reg.stop_all(drain=False)
        flight.close()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    report["frontend"]["launches"] = launches
    return launches


PARALLEL = {"model": 2, "fwd_rows": 4, "fwd_T": 256, "train_batch": 8,
            "train_T": 256, "train_steps": 4, "lr": 1e-3,
            "serve_clients": 8, "serve_requests": 4, "serve_rows": (1, 4),
            "serve_T": 128, "serve_batch": 4, "grow_to": 3,
            "gen_streams": 16, "slots": 8, "max_seq_len": 512,
            "max_prompt_len": 256, "buckets": "pow2@8", "prompt": (8, 200),
            "new_tokens": (4, 64), "int8_batch": 8, "int8_requests": 6}
NHWC_SPEC = ((224, 224, 3), np.float32)
# the sharded forward and the served rows against the unsharded model on
# the card, of max|logp| (one GEMM against slices of it and a row-split
# partial sum added in another order: sound readings ~1e-7 predicted); the
# swapped-halves fault must read above TP_FAULT_FLOOR
TP_TOL, TP_FAULT_FLOOR = 1e-5, 1e-2
# a training step's gradients against the unsharded model's from the same
# weights on the same batch: each leaf's ||g - g_ref|| over ||g_ref|| (over
# 1e-3 of the largest leaf's norm where a leaf's gradient is zero but for
# rounding, the key biases'); a row-parallel sum that drops its last
# partial must exceed it
TP_TRAIN_TOL = 1e-4


def card0(device):
    return torch.device("cuda", 0) if device.type == "cuda" else device


def tp_mesh(device, backend=None):
    """The phase's model group: the one card twice."""
    from bigdl_tpu_torch.parallel import create_mesh
    return create_mesh(model=PARALLEL["model"],
                       devices=[card0(device)] * PARALLEL["model"],
                       backend=backend)


def tp_forward_check(lm, device, card, report):
    """1. ``transformer_lm(shard=True)`` placed on the model group against
    the unsharded model on the card: log-probs of PARALLEL["fwd_rows"] x
    ``fwd_T`` tokens within TP_TOL of max|logp|; two halves of block 0's
    ``wq`` swapped above TP_FAULT_FLOOR.  Returns the unsharded twin."""
    from bigdl_tpu_torch.parallel import shard_module
    plain = copy.deepcopy(lm).to(device).eval()
    placed = shard_module(copy.deepcopy(lm), tp_mesh(device)).eval()
    gen = torch.Generator().manual_seed(PARALLEL["fwd_T"])
    tokens = torch.randint(0, lm[0].n_index, (PARALLEL["fwd_rows"],
                                              PARALLEL["fwd_T"]),
                           generator=gen).to(device)
    with torch.inference_mode():
        want, got = plain(tokens), placed(tokens)
        scale = float(want.abs().max())
        reading = float((got - want).abs().max()) / scale
        wq = placed[2][0][0][0][1].wq
        swap_shard_halves(wq)
        fault = float((placed(tokens) - want).abs().max()) / scale
        swap_shard_halves(wq)

    def timed(model):
        def run():
            with torch.inference_mode():
                model(tokens)
        return cuda_ms(run, budget_ms=200.0)
    ms = {"unsharded": timed(plain), "sharded": timed(placed)}
    shards = [tuple(p.shape) for p in wq.parts]
    print(f"parallel forward: transformer_lm(shard=True) on "
          f"{[str(d) for d in wq.devices]} ({len(shards)} shards of wq "
          f"{shards}), {tuple(tokens.shape)} tokens: max|dlogp| / max|logp| "
          f"{reading:.3e} (limit {TP_TOL}), swapped-halves fault "
          f"{fault:.3e} (floor {TP_FAULT_FLOOR}); ms a forward unsharded "
          f"{ms['unsharded']:.3f} sharded {ms['sharded']:.3f} [{card}]")
    if not (reading <= TP_TOL and fault > TP_FAULT_FLOOR):
        raise AssertionError(f"sharded forward {reading} fault {fault}")
    report["parallel"]["forward"] = {"reading": reading, "fault": fault,
                                     "ms": ms, "shards": shards}
    del placed
    return plain


def lm_samples(vocab, n, T, seed):
    """n (tokens, next tokens) windows of T random ids."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (n, T + 1)).astype(np.int64)
    return [Sample(r[:-1], r[1:]) for r in ids]


class TPTracing:
    """Mixin for a DistriOptimizer: each step's parameters before it
    (under their unsharded names, on the card), its batch, its loss and
    its gradients (unsharded names) in ``self.trace``."""

    def _train_driver(self, step_fn, device, run):
        from bigdl_tpu_torch.parallel.tensor_parallel import logical_tensors
        self.trace = []
        method = self.optim_method
        update = method.update

        def recorded(grads, params, state, lr, step):
            self.trace[-1]["grads"] = {
                k: g.detach().clone()
                for k, g in logical_tensors(run.net, grads).items()}
            return update(grads, params, state, lr, step)
        method.update = recorded

        def traced(x, y, lr, step):
            self.trace.append({
                "before": {k: v.detach().clone() for k, v in
                           logical_tensors(run.net, run.params).items()},
                "x": x.clone(), "y": y.clone()})
            loss = step_fn(x, y, lr, step)
            self.trace[-1]["loss"] = loss
            return loss
        try:
            return super()._train_driver(traced, device, run)
        finally:
            method.update = update


def tp_train(lm, samples, device, sharded, trace=False):
    """PARALLEL["train_steps"] steps of Adam through a world-1 NCCL
    DistriOptimizer: sharded (``param_specs`` over the model group) or
    not; (losses, step clock, optimizer)."""
    from bigdl_tpu_torch.parallel import build_param_specs
    model = copy.deepcopy(lm)
    cls = type("TPTraced", (TPTracing, optim.DistriOptimizer), {}) \
        if trace else optim.DistriOptimizer
    backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {"mesh": tp_mesh(device, backend=backend),
          "param_specs": build_param_specs(model)} if sharded else {}
    opt = (cls(model, DataSet.array(samples, distributed=True)
               >> SampleToMiniBatch(PARALLEL["train_batch"]),
               nn.TimeDistributedCriterion(nn.ClassNLLCriterion()),
               device=device, **kw)
           .set_optim_method(optim.Adam(PARALLEL["lr"])).set_seed(11)
           .set_end_when(optim.max_iteration(PARALLEL["train_steps"])))
    opt.losses, opt.clock = [], []

    def log(lr):
        opt.losses.append(opt.state["loss"])
        opt.clock.append(time.perf_counter())
    opt._log_train_iteration = log
    opt.optimize()
    return opt


def tp_step_reading(lm, trace, device):
    """Each traced step redone by the unsharded model on the card from the
    step's own weights: (worst loss share, worst gradient share)."""
    ref = copy.deepcopy(lm).to(device).train()
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion())
    params = dict(ref.named_parameters())
    worst_loss = worst_grad = 0.0
    for rec in trace:
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(rec["before"][k])
                p.requires_grad_(True)
                p.grad = None
        loss = crit.apply(ref(rec["x"]), rec["y"])
        loss.backward()
        got = float(loss.detach())
        worst_loss = max(worst_loss,
                         abs(got - float(rec["loss"])) / abs(got))
        norms = {k: float(p.grad.norm()) for k, p in params.items()}
        floor = 1e-3 * max(norms.values())
        for k, p in params.items():
            d = float((rec["grads"][k] - p.grad).norm())
            worst_grad = max(worst_grad, d / max(norms[k], floor))
    del ref
    return worst_loss, worst_grad


def tp_train_check(lm, device, card, report):
    """2. ``DistriOptimizer(param_specs=)`` at world 1 over NCCL (data=1,
    model=2) against the unsharded DistriOptimizer: every step's loss and
    gradients redone by the unsharded model from the sharded run's own
    weights (TP_TRAIN_TOL), a row-parallel sum that drops its last partial
    above it; then both runs timed, ms a step."""
    import torch.distributed as dist

    from bigdl_tpu_torch.parallel import tensor_parallel as tp
    samples = lm_samples(lm[0].n_index, PARALLEL["train_batch"]
                         * PARALLEL["train_steps"], PARALLEL["train_T"], 5)
    try:
        opt = tp_train(lm, samples, device, True, trace=True)
        loss_r, grad_r = tp_step_reading(lm, opt.trace, device)
        del opt
        real = tp.row_sum
        tp.row_sum = lambda parts, home: real(list(parts)[:-1], home)
        try:
            bad = tp_train(lm, samples, device, True, trace=True)
        finally:
            tp.row_sum = real
        fault = tp_step_reading(lm, bad.trace, device)
        del bad
        torch.cuda.empty_cache()
        runs = {name: tp_train(lm, samples, device, name == "sharded")
                for name in ("unsharded", "sharded")}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        Engine.set_mesh(None)
    ms = {n: float(np.mean(np.diff(o.clock)) * 1e3) for n, o in runs.items()}
    gap = max(abs(a - b) / abs(b) for a, b in zip(runs["sharded"].losses,
                                                   runs["unsharded"].losses))
    print(f"parallel train: DistriOptimizer(param_specs=) data=1 model=2 "
          f"over {'NCCL' if device.type == 'cuda' else 'gloo'}, Adam "
          f"{PARALLEL['lr']}, batch "
          f"{PARALLEL['train_batch']} x T {PARALLEL['train_T']}, "
          f"{PARALLEL['train_steps']} steps: each step redone unsharded "
          f"from its own weights: loss share {loss_r:.3e}, gradient share "
          f"{grad_r:.3e} (limit {TP_TRAIN_TOL}); dropped-partial fault "
          f"loss {fault[0]:.3e} gradient {fault[1]:.3e}; losses sharded "
          f"{[round(v, 6) for v in runs['sharded'].losses]} unsharded "
          f"{[round(v, 6) for v in runs['unsharded'].losses]} (largest "
          f"share apart {gap:.3e}); ms a step sharded {ms['sharded']:.3f} "
          f"unsharded {ms['unsharded']:.3f} [{card}]")
    if not (max(loss_r, grad_r) <= TP_TRAIN_TOL
            and fault[1] > TP_TRAIN_TOL):
        raise AssertionError(f"sharded training {loss_r} {grad_r} {fault}")
    if not runs["sharded"].losses[-1] < runs["sharded"].losses[0]:
        raise AssertionError("the sharded run's loss did not fall")
    report["parallel"]["train"] = {
        "loss_share": loss_r, "grad_share": grad_r, "fault": list(fault),
        "losses": {n: o.losses for n, o in runs.items()},
        "loss_gap": gap, "ms_a_step": ms}


def tp_serve_check(lm, plain, device, card, report):
    """3. ``ShardedReplicaSet`` over ``[cuda:0] * 4`` in groups of two (2
    slots) behind the front end: 8 clients x 4 requests of 1-4 rows of
    ``serve_T`` tokens (npy), every row within TP_TOL of the unsharded
    model on the card; grown to 3 slots (slot 2 takes group 0), each slot
    answers again."""
    from bigdl_tpu_torch.frontend import FrontendServer
    from bigdl_tpu_torch.serving import ShardedReplicaSet
    T, V = PARALLEL["serve_T"], lm[0].n_index
    rs = ShardedReplicaSet(lm, devices=[card0(device)] * 4,
                           devices_per_replica=2,
                           input_spec=((T,), np.int64),
                           max_batch_size=PARALLEL["serve_batch"],
                           name="tp")
    fe = FrontendServer(ModelRegistry(device=device), backends={"tp": rs},
                        port=0)
    fe.start()
    rng = np.random.default_rng(31)
    jobs = [rng.integers(0, V, (int(rng.integers(
        PARALLEL["serve_rows"][0], PARALLEL["serve_rows"][1] + 1)), T))
        for _ in range(PARALLEL["serve_clients"]
                       * PARALLEL["serve_requests"])]
    got, errors, lat = {}, [], []

    def client(c):
        try:
            for i in range(c, len(jobs), PARALLEL["serve_clients"]):
                t0 = time.monotonic()
                st, _h, y = wire_predict(fe.port, "tp", jobs[i], False)
                lat.append(time.monotonic() - t0)
                if st != 200:
                    raise AssertionError(f"predict {i}: {st} {y[:200]}")
                got[i] = y
        except Exception as e:  # re-raised below
            errors.append(e)

    def worst(items):
        out = 0.0
        with torch.inference_mode():
            for x, y in items:
                want = plain(torch.from_numpy(x).to(device)).cpu().numpy()
                out = max(out, float(np.abs(y - want).max())
                          / float(np.abs(want).max()))
        return out

    try:
        t0 = time.monotonic()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(PARALLEL["serve_clients"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.monotonic() - t0
        if errors or len(got) != len(jobs):
            raise RuntimeError(f"sharded serve clients: {errors[:3]}")
        rows = sum(len(j) for j in jobs)
        reading = worst((jobs[i], got[i]) for i in range(len(jobs)))
        dispatches = [r.stats()["dispatch_count"] for r in rs._replicas]
        rs.set_replica_count(PARALLEL["grow_to"])
        groups = [rs.group_index(i) for i in range(rs.n_replicas)]
        again = []
        for i, svc in enumerate(rs._replicas):
            x = jobs[i]
            again.append((x, svc.predict(x)))
        st, _h, y = wire_predict(fe.port, "tp", jobs[0], False)
        if st != 200:
            raise AssertionError(f"predict after the grow: {st}")
        again.append((jobs[0], y))
        reading_grown = worst(again)
    finally:
        fe.stop()
        rs.stop(drain=False)
    print(f"parallel serve: ShardedReplicaSet 2 slots of [cuda:0, cuda:0] "
          f"behind the front end: {len(jobs)} requests ({rows} rows of {T} "
          f"tokens, npy) from {PARALLEL['serve_clients']} clients in "
          f"{wall:.2f} s ({rows / wall:.1f} rows/s, latency p50 "
          f"{pct_ms(lat, 50)} ms p99 {pct_ms(lat, 99)} ms), dispatches a "
          f"slot {dispatches}; rows vs the unsharded model {reading:.3e} "
          f"(limit {TP_TOL}); grown to {rs.n_replicas} slots on groups "
          f"{groups}, each slot and the wire again {reading_grown:.3e} "
          f"[{card}]")
    if not (reading <= TP_TOL and reading_grown <= TP_TOL
            and groups == [0, 1, 0]):
        raise AssertionError(f"sharded serving {reading} {reading_grown} "
                             f"{groups}")
    report["parallel"]["serve"] = {
        "requests": len(jobs), "rows": rows, "wall_s": wall,
        "rows_per_s": rows / wall, "p50_ms": pct_ms(lat, 50),
        "p99_ms": pct_ms(lat, 99), "dispatches": dispatches,
        "reading": reading, "reading_grown": reading_grown,
        "groups": groups}


def tp_decode_check(lm, plain, device, card, report):
    """4. ``DecodeService(mesh=)`` (model=2 on the card, its KV cache in
    two head halves) decoding ``gen_streams`` streams: every token's
    teacher-forced log-probs through the sharded carry within GEN_TOL of
    the unsharded model's full context on the card, tokens its argmax but
    at near ties (counted), three planted faults above GEN_TOL; the KV
    bytes of one shard."""
    from bigdl_tpu_torch.serving import DecodeService
    rng = np.random.default_rng(97)
    V = lm[0].n_index
    jobs = [(rng.integers(0, V, int(rng.integers(
        PARALLEL["prompt"][0], PARALLEL["prompt"][1] + 1))).tolist(),
        int(rng.integers(PARALLEL["new_tokens"][0],
                         PARALLEL["new_tokens"][1] + 1)))
        for _ in range(PARALLEL["gen_streams"])]
    t0 = time.monotonic()
    dec = DecodeService(lm, mesh=tp_mesh(device), slots=PARALLEL["slots"],
                        max_seq_len=PARALLEL["max_seq_len"],
                        max_prompt_len=PARALLEL["max_prompt_len"],
                        prefill_buckets=PARALLEL["buckets"], name="lm_tp")
    warm = time.monotonic() - t0
    try:
        t0 = time.monotonic()
        futs = [dec.submit(p, max_new_tokens=n) for p, n in jobs]
        served = [list(f.result(timeout=600).tokens) for f in futs]
        wall = time.monotonic() - t0
        steps = dec.steps_done
        model = dec._model
        reading, ties = 0.0, 0
        for (prompt, _n), toks in zip(jobs, served):
            inc = teacher_forced(model, prompt, toks, device)
            full = full_context(plain, prompt, toks, device)
            reading = max(reading, float((inc - full).abs().max()))
            top2 = full.topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > 2 * GEN_TOL
            ties += int((~clear).sum())
            if not torch.equal(full.argmax(-1)[clear],
                               torch.tensor(toks)[clear]):
                raise AssertionError("a sharded token is not the unsharded "
                                     "model's argmax at a clear margin")
        prompt, _n = jobs[0]
        faults = planted_decode_faults(
            model, prompt, served[0],
            full_context(plain, prompt, served[0], device), device)
        per_shard, kv = dec.kv_bytes_per_shard, dec.kv_bytes
        parts = [str(p.device) for p in dec._k.parts]
    finally:
        dec.stop(drain=False)
    n_tok = sum(len(t) for t in served)
    print(f"parallel decode: DecodeService(mesh=model 2) slots "
          f"{PARALLEL['slots']}, max_seq_len {PARALLEL['max_seq_len']}, "
          f"warmup {warm:.2f} s; {len(jobs)} streams, {n_tok} tokens in "
          f"{wall:.2f} s ({n_tok / wall:.1f} tokens/s, {steps} steps); KV "
          f"cache {kv} bytes, {per_shard} bytes a shard on {parts}; "
          f"teacher-forced vs the unsharded full context {reading:.3e} "
          f"(limit {GEN_TOL}), {ties} near ties; planted faults "
          + ", ".join(f"{k} {v:.3e}" for k, v in faults.items())
          + f" [{card}]")
    if not (reading <= GEN_TOL and min(faults.values()) > GEN_TOL
            and per_shard * PARALLEL["model"] == kv):
        raise AssertionError(f"sharded decode {reading} {faults} "
                             f"{per_shard} {kv}")
    report["parallel"]["decode"] = {
        "streams": len(jobs), "tokens": n_tok, "wall_s": wall,
        "tokens_per_s": n_tok / wall, "steps": steps, "reading": reading,
        "near_ties": ties, "faults": faults, "kv_bytes": kv,
        "kv_bytes_per_shard": per_shard}


def nhwc_twins(seed):
    """The ResNet-50 in NHWC (seeded weights) and its NCHW twin."""
    from bigdl_tpu_torch.interop import load_jax_params, to_jax_params
    nhwc = resnet50(format="NHWC").initialize(
        torch.Generator().manual_seed(seed))
    return nhwc, load_jax_params(resnet50(), *to_jax_params(nhwc))


def nhwc_kernel_phase(seed, device, card, report):
    """B4 at the GEMMs of the NHWC int8 ResNet-50's forward of
    ``int8_batch`` rows (the parallel phase's path), which must be the
    NCHW twin's, through the kernel phase: checked against the plain
    version and timed.  Run while the process is young: late in a long
    run the profiler loses a session's first launches, then whole
    sessions (PERF.md section 7).  Returns the kernel phase's totals."""
    nhwc, nchw = nhwc_twins(seed)
    probe = quantize(nhwc).to(device)
    shapes = gemm_shapes(probe, device, PARALLEL["int8_batch"], NHWC_SPEC)
    del probe
    twin = quantize(nchw).to(device)
    if shapes != gemm_shapes(twin, device, PARALLEL["int8_batch"]):
        raise AssertionError("the NHWC path's GEMMs are not the NCHW twin's")
    del twin
    torch.cuda.empty_cache()
    print(f"nhwc int8 resnet50 batch {PARALLEL['int8_batch']}: "
          f"{len(shapes)} GEMM launches per forward, {len(set(shapes))} "
          f"distinct shapes, the NCHW twin's")
    return kernel_phase(shapes, device, card, report,
                        PARALLEL["int8_batch"])


def nhwc_int8_check(seed, device, card, report):
    """5. The int8 ResNet-50 in NHWC, both modes, deployed through
    ``ModelRegistry.deploy(quantize=...)`` beside its NCHW twin (the same
    weights): ``int8_requests`` requests of 1-4 rows, each alone (a
    dynamic request's scale is its batch's), the NHWC rows bitwise the
    NCHW twin's, transposed; B4's launches a dispatch on the NHWC path
    (54, ``INTEROP["gemms"]``: the counts set to 0 just before it).
    Returns {mode: launches}."""
    nhwc, nchw = nhwc_twins(seed)
    gen = torch.Generator().manual_seed(seed + 5)
    pool = torch.randn((8,) + SPEC[0], generator=gen).numpy()
    rng = np.random.default_rng(seed + 6)
    jobs = [rng.integers(0, len(pool), int(rng.integers(1, 5)))
            for _ in range(PARALLEL["int8_requests"])]
    launches = {}
    with ModelRegistry(device=device) as reg:
        for mode in ("weight_only", "dynamic"):
            q = True if mode == "weight_only" else "dynamic"
            kw = {"max_batch_size": PARALLEL["int8_batch"], "quantize": q}
            v_h = reg.deploy(f"nhwc_{mode}", nhwc, input_spec=NHWC_SPEC, **kw)
            v_c = reg.deploy(f"nchw_{mode}", nchw, input_spec=SPEC, **kw)
            int8_gemm.reset_counts()
            d0 = v_h.stats()["dispatch_count"]
            ys = [v_h.predict(pool[idx].transpose(0, 2, 3, 1).copy())
                  for idx in jobs]
            n = int8_gemm.launches
            dispatches = v_h.stats()["dispatch_count"] - d0
            same = all(np.array_equal(y, v_c.predict(pool[idx]))
                       for y, idx in zip(ys, jobs))
            launches[mode] = n
            print(f"parallel nhwc int8 {mode}: {len(jobs)} requests alone, "
                  f"{dispatches} dispatches, B4 {n} launches "
                  f"({n / max(dispatches, 1):.1f} a dispatch, "
                  f"{dict(int8_gemm.variant_launches)}); rows bitwise the "
                  f"NCHW twin's: {same} [{card}]")
            if not same or n != INTEROP["gemms"] * dispatches:
                raise AssertionError(f"nhwc int8 {mode}: bitwise {same}, "
                                     f"{n} launches, {dispatches} "
                                     f"dispatches")
            reg.undeploy(f"nhwc_{mode}")
            reg.undeploy(f"nchw_{mode}")
    report["parallel"]["nhwc_int8"] = {"launches": launches,
                                       "requests": len(jobs)}
    return launches


def parallel_phase(seed, device, card, report):
    """Tensor parallelism and sharded serving on the card (PARALLEL), and
    the NHWC int8 ResNet-50 on B4.  Returns B4's launches by mode on the
    NHWC path."""
    from bigdl_tpu_torch.models import transformer_lm
    report["parallel"] = {}
    lm = transformer_lm(shard=True).initialize(seed).eval()
    n_params = sum(p.numel() for p in lm.parameters())
    print(f"parallel: transformer_lm(shard=True) at its defaults, "
          f"{n_params} parameters, model group of {PARALLEL['model']} on "
          f"{device}")
    t0 = time.monotonic()
    plain = tp_forward_check(lm, device, card, report)
    print(f"phase parallel-forward: {time.monotonic() - t0:.1f} s")
    for name, fn in (
            ("train", lambda: tp_train_check(lm, device, card, report)),
            ("serve", lambda: tp_serve_check(lm, plain, device, card,
                                             report)),
            ("decode", lambda: tp_decode_check(lm, plain, device, card,
                                               report))):
        t0 = time.monotonic()
        fn()
        torch.cuda.empty_cache()
        print(f"phase parallel-{name}: {time.monotonic() - t0:.1f} s")
    del plain
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    out = nhwc_int8_check(seed, device, card, report)
    torch.cuda.empty_cache()
    print(f"phase parallel-nhwc-int8: {time.monotonic() - t0:.1f} s")
    return out


# ------------------------------------------------- quantized recurrent cells
# the keras phase's text classifiers (KERAS: the synthetic news corpus's
# vocabulary, embed 100, hidden 128, 200 tokens, 20 classes), seeded, their
# LSTM/GRU cells int8 through ModelRegistry.deploy(quantize=...): requests
# of 128 rows, each alone (a dynamic step's activation scale is taken over
# its whole batch's [x_t, h])
QRNN = {"rows": 128, "requests": 2}
# B4 launches a forward: one a step and direction for the LSTM's single
# panel, two for the GRU's (gates, candidate), and the Dense head
QRNN_FORWARD = {"lstm": 2 * KERAS["seq"] + 1, "gru": 4 * KERAS["seq"] + 1}
# served rows against the same quantized model on the CPU, as a share of
# max|y|: between the sound reading (the same models on the CPU with one
# ulp of noise on the gates read 1.6e-7 in both modes) and the two planted
# faults every run measures and requires to exceed it (2.0e-3 to 4.0e-2
# in that CPU run)
QRNN_TOL = 1e-4
_NEWS = {}


def news_cached(seed):
    if seed not in _NEWS:
        _NEWS[seed] = news_corpus(seed)
    return _NEWS[seed]


def qrnn_model(cell, vocab, seed):
    """The Keras text classifier's module with seeded weights."""
    return keras_text(cell, vocab).core_module().initialize(seed)


def qrnn_fault(q, cell):
    """A planted fault, in place in the quantized model ``q``: the LSTM's
    forward cell with its i and f gate rows swapped (panel, scales and
    bias), the GRU's forward candidate scales x127/128."""
    c = next(m for m in q.modules() if isinstance(m, _QuantizedCellBase))
    with torch.no_grad():
        if cell == "lstm":
            H = c.hidden_size
            for name in ("wq", "ws", "bias"):
                t = getattr(c, name)
                t[:2 * H] = torch.cat([t[H:2 * H], t[:H]])
        else:
            c.cs.mul_(127 / 128)
    return q


def qrnn_kernel_phase(seed, device, card, report):
    """B4 at the GEMMs of one quantized forward of each text classifier
    (``QRNN["rows"]`` rows): the cells' projections of [x_t, h] (M 128, K
    228) and the head's, through the kernel phase, with the dequantized
    f32 ``addmm`` as the library call in both modes and, for dynamic,
    ``_int_mm`` beside it (K zero-padded to 232).  Run while the process
    is young (PERF.md section 7).  Returns {cell: the phase's totals}."""
    _, _, vocab = news_cached(seed)
    out = {}
    for cell in ("lstm", "gru"):
        probe = quantize(qrnn_model(cell, vocab, seed)).to(device)
        shapes = gemm_shapes(probe, device, QRNN["rows"],
                             ((KERAS["seq"],), np.int32))
        del probe
        if len(shapes) != QRNN_FORWARD[cell]:
            raise AssertionError(f"quantized {cell} forward ran "
                                 f"{len(shapes)} GEMMs, want "
                                 f"{QRNN_FORWARD[cell]}")
        print(f"quantized text {cell} batch {QRNN['rows']}: {len(shapes)} "
              f"GEMM launches per forward, shapes "
              f"{sorted(set(shapes))}")
        out[cell] = kernel_phase(shapes, device, card, report, QRNN["rows"],
                                 dequantized_library=True)
    return out


def qrnn_phase(seed, device, card, report):
    """The two quantized text classifiers served in both modes (module
    docstring, 32).  Returns ({mode: B4 launches}, {mode: variants})."""
    ids, _, vocab = news_cached(seed)
    B = QRNN["rows"]
    requests = [ids[r * B:(r + 1) * B] for r in range(QRNN["requests"])]
    spec = ((KERAS["seq"],), np.int32)
    report["quantized_rnn"] = {}
    launches = dict.fromkeys(("weight_only", "dynamic"), 0)
    variants = {}
    with ModelRegistry(device=device) as reg:
        for cell in ("lstm", "gru"):
            model = qrnn_model(cell, vocab, seed)
            for mode in ("weight_only", "dynamic"):
                name = f"text_{cell}_{mode}"
                t0 = time.monotonic()
                svc = reg.deploy(name, model, input_spec=spec,
                                 quantize=True if mode == "weight_only"
                                 else mode, max_batch_size=B, buckets=(B,))
                deploy_s = time.monotonic() - t0
                n_cells = sum(isinstance(m, _QuantizedCellBase)
                              for m in svc.model.modules())
                int8_gemm.reset_counts()
                lstm_cell.fwd_launches = lstm_cell.bwd_launches = 0
                d0 = svc.stats()["dispatch_count"]
                t0 = time.monotonic()
                served = [reg.predict(name, x, timeout=600)
                          for x in requests]
                wall = time.monotonic() - t0
                n = int8_gemm.launches
                var = {k: v for k, v in int8_gemm.variant_launches.items()
                       if v}
                b2 = lstm_cell.fwd_launches + lstm_cell.bwd_launches
                dispatches = svc.stats()["dispatch_count"] - d0
                reg.undeploy(name)
                cpu_q = quantize(model, mode=mode)
                with torch.inference_mode():
                    wants = [cpu_q(torch.from_numpy(x)).numpy()
                             for x in requests]
                reading = max(rel_err(y, w) for y, w in zip(served, wants))
                fq = qrnn_fault(quantize(model, mode=mode), cell).to(device)
                with torch.inference_mode():
                    fault = rel_err(fq(torch.from_numpy(requests[0])
                                       .to(device)).cpu().numpy(), wants[0])
                del fq
                fault_name = ("lstm_i_f_gates_swapped" if cell == "lstm"
                              else "gru_candidate_scales_127_128")
                cells = QRNN_FORWARD[cell] - 1
                print(f"quantized-rnn {cell} {mode}: {len(requests)} "
                      f"requests of {B} x {KERAS['seq']} tokens alone, "
                      f"{dispatches} dispatches, {n_cells} int8 cells; B4 "
                      f"{n} launches ({n / max(dispatches, 1):.0f} a "
                      f"dispatch, {var}), B2f+B2b {b2}; rows vs the CPU "
                      f"{reading:.3e} (tol {QRNN_TOL}), planted fault "
                      f"{fault_name} {fault:.3e}; "
                      f"{wall / len(requests) * 1e3:.1f} ms a request, "
                      f"deploy {deploy_s:.2f} s [{card}]")
                report["quantized_rnn"][f"{cell}_{mode}"] = {
                    "requests": len(requests), "dispatches": dispatches,
                    "launches": n, "variant_launches": var, "b2": b2,
                    "reading": reading, "fault": {fault_name: fault},
                    "ms_per_request": wall / len(requests) * 1e3,
                    "deploy_s": deploy_s}
                if not (n_cells == 2 and dispatches == len(requests)
                        and n == QRNN_FORWARD[cell] * dispatches
                        and var.get(f"mma_{mode}", 0)
                        in (cells * dispatches, (cells + 1) * dispatches)
                        and b2 == 0):
                    raise AssertionError(
                        f"quantized {cell} {mode}: {n_cells} cells, "
                        f"{dispatches} dispatches, B4 {n} {var}, B2 {b2}")
                if not (reading <= QRNN_TOL < fault):
                    raise AssertionError(
                        f"quantized {cell} {mode}: reading {reading:.3e}, "
                        f"fault {fault:.3e}, limit {QRNN_TOL}")
                launches[mode] += n
                for k, v in var.items():
                    variants.setdefault(mode, {})
                    variants[mode][k] = variants[mode].get(k, 0) + v
    return launches, variants


# ----------------------------------------- sequence and pipeline parallelism
# ring attention at transformer_lm()'s head geometry over a long sequence;
# GPipe of four of its blocks; its whole model through
# MicrobatchedSequential; NeuralCF at the NCF paper's MovieLens-1M counts
SEQPIPE = {"B": 2, "H": 8, "D": 64, "T": 8192, "groups": (2, 4),
           "stages": 4, "embed": 512, "heads": 8, "mlp": 2048,
           "microbatches": 8, "mb_rows": 4, "tokens": 256, "sgd_steps": 4,
           "lr": 0.05, "ms_microbatches": 4, "ncf_users": 6040,
           "ncf_items": 3706, "ncf_batch": 256, "ncf_steps": 8,
           "ncf_lr": 1e-3}
# ring against full attention on the card, forward and each gradient of
# sum(out**2), as a share of max|y|: f32 sums of 8192 keys in another
# order (the CPU at T 2048 reads 9.0e-7), bf16 outputs and
# gradients one bf16 ulp apart (1.2e-2 there); the planted fault reads O(1)
RING_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# GPipe and MicrobatchedSequential against their unpipelined oracle: the
# forward as a share of max|y|; a training step's loss (relative) and each
# gradient (a share of the model's largest), the products at microbatch
# rows instead of the whole batch's
PIPE_TOL, PIPE_TRAIN_TOL = 1e-5, 1e-4
# NeuralCF's steps on the card redone on the CPU (wd_step_reading), and
# the peephole cells' and RecurrentDecoder's forwards against the CPU
NCF_TRAIN_TOL = 1e-4


def ring_check(device, card, report):
    """Ring attention on ``[cuda:0] * p`` against full attention on the
    card (module docstring, 33).  Returns the readings."""
    import sys as _sys
    from bigdl_tpu_torch.parallel import create_mesh, ring_attention
    ring_mod = _sys.modules["bigdl_tpu_torch.parallel.ring_attention"]
    dev = card0(device)
    c = SEQPIPE
    gen = torch.Generator(device=dev).manual_seed(77)
    base = [torch.randn(c["B"], c["H"], c["T"], c["D"], generator=gen,
                        device=dev) for _ in range(3)]
    sound_mask = ring_mod._mask
    rows = {}

    def run(fn, qs):
        """(output, gradients, peak bytes and seconds of fn and the
        backward of sum(out**2), the forward's peak under no_grad); the
        no_grad forward first, which also warms fn up."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            fn(*qs)
        torch.cuda.synchronize()
        fwd_peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        out = fn(*qs)
        grads = torch.autograd.grad(out.float().square().sum(), qs)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        return (out.detach(), grads, torch.cuda.max_memory_allocated(),
                fwd_peak, secs)

    def share(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for causal in (False, True):
            qs = [t.to(dtype).requires_grad_(True) for t in base]
            full, g_full, f_peak, f_fwd, f_s = run(
                lambda q, k, v: nn.dot_product_attention(
                    q, k, v, causal=causal), qs)
            for p in c["groups"]:
                mesh = create_mesh(seq=p, devices=[dev] * p)
                ring = lambda q, k, v: ring_attention(  # noqa: E731
                    q, k, v, mesh, causal=causal)
                out, g, peak, fwd, secs = run(ring, qs)
                reading = max([share(out, full)]
                              + [share(a, b) for a, b in zip(g, g_full)])
                fault = None
                if causal:
                    ring_mod._mask = (lambda r, src, tl, cz, d:
                                      sound_mask(r, r, tl, cz, d))
                    try:
                        with torch.no_grad():
                            fault = share(ring(*qs), full)
                    finally:
                        ring_mod._mask = sound_mask
                key = f"{dname}_{'causal' if causal else 'full'}_p{p}"
                rows[key] = {"reading": reading, "fault": fault,
                             "peak_bytes": peak, "fwd_peak_bytes": fwd,
                             "s": secs, "full_peak_bytes": f_peak,
                             "full_fwd_peak_bytes": f_fwd, "full_s": f_s}
                print(f"ring attention {key}: B {c['B']} H {c['H']} T "
                      f"{c['T']} D {c['D']} on [cuda:0] x {p}: vs full "
                      f"attention (forward, 3 gradients) {reading:.3e} "
                      f"(tol {RING_TOL[dname]})"
                      + (f", mask offset dropped {fault:.3e}"
                         if fault is not None else "")
                      + f"; peak fwd+bwd ring {peak / 2**30:.2f} GiB, full "
                      f"{f_peak / 2**30:.2f} GiB; forward alone ring "
                      f"{fwd / 2**30:.2f} GiB, full {f_fwd / 2**30:.2f} "
                      f"GiB; {secs:.3f} s vs {f_s:.3f} s [{card}]")
                if not (reading <= RING_TOL[dname]
                        and (fault is None or fault > RING_TOL[dname])):
                    raise AssertionError(f"ring attention {key}: reading "
                                         f"{reading}, fault {fault}")
                del out, g
            del full, g_full, qs
    report["seq_pipe"]["ring"] = rows
    return rows


def pipe_share(got, want):
    return max(float((a - b).abs().max()) for a, b in zip(got, want)) \
        / max(float(b.abs().max()) for b in want)


def gpipe_check(seed, device, card, report):
    """GPipe of four transformer blocks on ``[cuda:0] * 4`` against its
    sequential oracle: the forward, then SGD steps each redone by the
    oracle from the step's own weights; a microbatch-order fault."""
    from bigdl_tpu_torch.models import transformer_block
    from bigdl_tpu_torch.parallel import GPipe, create_mesh
    c, dev = SEQPIPE, card0(device)
    S = c["stages"]
    gp = GPipe(transformer_block(c["embed"], c["heads"], c["mlp"]), S,
               mesh=create_mesh(pipe=S, devices=[dev] * S)).initialize(seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 41)
    shape = (c["microbatches"], c["mb_rows"], c["tokens"], c["embed"])
    x = torch.randn(shape, generator=gen, device=dev)
    target = 0.5 * torch.randn(shape, generator=gen, device=dev)
    with torch.no_grad():
        gp(x), gp.apply_reference(x)  # warm both up
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = gp(x)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        ref = gp.apply_reference(x)
        torch.cuda.synchronize()
        t2 = time.monotonic()
    fwd = pipe_share([out], [ref])
    params = list(gp.parameters())
    for p in params:
        p.requires_grad_(True)

    def step(fwd_fn):
        loss = (fwd_fn(x) - target).square().mean()
        return loss.item(), torch.autograd.grad(loss, params)

    readings, losses, fault = [], [], None
    for j in range(c["sgd_steps"]):
        lp, gpipe_g = step(gp)
        lr_, ref_g = step(gp.apply_reference)
        readings.append(max(abs(lp - lr_) / abs(lr_),
                            pipe_share(gpipe_g, ref_g)))
        losses.append(lp)
        if j == 0:  # the planted fault: microbatch order shifted by one
            lf, gf = step(lambda v: gp(v.roll(1, 0)))
            fault = max(abs(lf - lr_) / abs(lr_), pipe_share(gf, ref_g))
        with torch.no_grad():
            for p, g in zip(params, gpipe_g):
                p.sub_(c["lr"] * g)
    train = max(readings)
    print(f"gpipe: {S} x transformer_block({c['embed']}, {c['heads']}, "
          f"{c['mlp']}) on [cuda:0] x {S}, {c['microbatches']} microbatches "
          f"of {c['mb_rows']} x {c['tokens']} tokens: forward vs "
          f"apply_reference {fwd:.3e} (tol {PIPE_TOL}); {c['sgd_steps']} "
          f"SGD steps each vs the oracle {train:.3e} (tol {PIPE_TRAIN_TOL}), "
          f"microbatch order shifted {fault:.3e}; losses "
          + ", ".join(f"{v:.6f}" for v in losses)
          + f"; forward {(t1 - t0) * 1e3:.1f} ms pipelined, "
          f"{(t2 - t1) * 1e3:.1f} ms oracle [{card}]")
    report["seq_pipe"]["gpipe"] = {"forward": fwd, "train": train,
                                   "fault": fault, "losses": losses,
                                   "forward_ms": (t1 - t0) * 1e3,
                                   "oracle_ms": (t2 - t1) * 1e3}
    if not (fwd <= PIPE_TOL and train <= PIPE_TRAIN_TOL
            and fault > PIPE_TRAIN_TOL and losses[-1] < losses[0]):
        raise AssertionError(f"gpipe: forward {fwd}, train {train}, fault "
                             f"{fault}, losses {losses}")


def microbatched_check(seed, device, card, report):
    """``partition_sequential(transformer_lm(), 4)`` through
    ``MicrobatchedSequential`` against the unpipelined model: the NLL of
    16 x 256 tokens and its gradients."""
    from bigdl_tpu_torch.models import transformer_lm
    from bigdl_tpu_torch.parallel import (MicrobatchedSequential,
                                          partition_sequential)
    c, dev = SEQPIPE, card0(device)
    lm = transformer_lm().initialize(seed).to(dev)
    stages = partition_sequential(lm, c["stages"])
    ms = MicrobatchedSequential(stages, c["ms_microbatches"])
    gen = torch.Generator(device=dev).manual_seed(seed + 43)
    n = c["ms_microbatches"] * c["mb_rows"]
    vocab = lm[0].n_index
    tokens = torch.randint(0, vocab, (n, c["tokens"]), generator=gen,
                           device=dev)
    targets = torch.randint(0, vocab, (n, c["tokens"]), generator=gen,
                            device=dev)
    params = list(lm.parameters())
    for p in params:
        p.requires_grad_(True)
    got = {}
    for name, fn in (("microbatched", ms), ("whole", lm)):
        t0 = time.monotonic()
        logp = fn(tokens)
        loss = -logp.gather(-1, targets[..., None]).mean()
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        got[name] = (logp.detach(), loss.item(), grads,
                     time.monotonic() - t0)
        del logp
    (y, l_ms, g_ms, s_ms), (want, l_lm, g_lm, s_lm) = \
        got["microbatched"], got["whole"]
    fwd = pipe_share([y], [want])
    train = max(abs(l_ms - l_lm) / abs(l_lm), pipe_share(g_ms, g_lm))
    print(f"microbatched transformer_lm: stages "
          f"{[len(s) for s in stages]}, {c['ms_microbatches']} microbatches "
          f"of {c['mb_rows']} x {c['tokens']} tokens: log-probs vs the "
          f"unpipelined model {fwd:.3e} (tol {PIPE_TOL}), loss and "
          f"gradients {train:.3e} (tol {PIPE_TRAIN_TOL}); {s_ms:.3f} s vs "
          f"{s_lm:.3f} s a forward and backward [{card}]")
    report["seq_pipe"]["microbatched"] = {"forward": fwd, "train": train,
                                          "s": s_ms, "whole_s": s_lm}
    if not (fwd <= PIPE_TOL and train <= PIPE_TRAIN_TOL):
        raise AssertionError(f"microbatched: forward {fwd}, train {train}")
    for p in params:
        p.requires_grad_(False)


def ncf_check(seed, device, card, report):
    """NeuralCF at MovieLens-1M's counts through LocalOptimizer (Adam,
    BCE) on the card, each step redone on the CPU from the card's weights
    (:func:`wd_step_reading`); the head weight x127/128 at init must read
    above the limit."""
    from bigdl_tpu_torch.dataset import movielens
    from bigdl_tpu_torch.models import NeuralCF
    c = SEQPIPE
    B, K = c["ncf_batch"], c["ncf_steps"]
    r = movielens.synthetic_ratings(c["ncf_users"], c["ncf_items"], B * K,
                                    seed=seed)
    users, items = r[:, 0] - 1, r[:, 1] - 1
    y = (r[:, 2] >= 4).astype(np.float32)
    batches = [MiniBatch((users[s:s + B], items[s:s + B]), y[s:s + B])
               for s in range(0, B * K, B)]
    init = NeuralCF(c["ncf_users"], c["ncf_items"]).initialize(seed)

    def run(model):
        adam = RecordingAdam(learning_rate=c["ncf_lr"])
        losses = []

        class Recording(LocalOptimizer):
            def _log_train_iteration(self, lr):
                losses.append(self.state["loss"])

        t0 = time.monotonic()
        (Recording(model, DataSet.array(np.zeros(B * K))
                   >> Prebuilt(batches, per=B), SqueezedBCE(),
                   device=device)
         .set_optim_method(adam).set_end_when(optim.max_iteration(K))
         .optimize())
        return losses, adam.steps, time.monotonic() - t0

    def cpu_step(init, params, batch):
        m = copy.deepcopy(init)
        with torch.no_grad():
            for k, p in m.named_parameters():
                p.copy_(params[k])
                p.requires_grad_(True)
        u, i = batch.input
        loss = SqueezedBCE().apply(m((torch.from_numpy(u),
                                      torch.from_numpy(i))),
                                   torch.from_numpy(batch.target))
        loss.backward()
        return loss.item(), {k: p.grad.double()
                             for k, p in m.named_parameters()}

    losses, steps, wall = run(copy.deepcopy(init))
    sound, worst = wd_step_reading(losses, steps, init, batches, cpu_step)
    bad = copy.deepcopy(init)
    with torch.no_grad():
        bad.head.weight.mul_(127 / 128)
    fault = wd_step_reading(*run(bad)[:2], init, batches, cpu_step)[0]
    print(f"neural cf: {c['ncf_users']} users x {c['ncf_items']} items, "
          f"embed 16, MLP (64, 32, 16), {K} Adam steps of batch {B} in "
          f"{wall:.2f} s: card vs CPU step by step {sound:.3e} (tol "
          f"{NCF_TRAIN_TOL}; largest {worst[:2]}), head weight x127/128 "
          f"{fault:.3e}; losses " + ", ".join(f"{v:.6f}" for v in losses)
          + f" [{card}]")
    report["seq_pipe"]["neural_cf"] = {"reading": sound, "fault": fault,
                                       "losses": losses, "wall_s": wall}
    if not (sound <= NCF_TRAIN_TOL < fault):
        raise AssertionError(f"neural cf: reading {sound}, fault {fault}")


def peephole_check(seed, device, card, report):
    """The peephole cells and RecurrentDecoder: one forward each on the
    card against the CPU within NCF_TRAIN_TOL of max|y|; the LSTM
    peephole's output-gate row zeroed must read above it."""
    dev = card0(device)
    cases = {
        "lstm_peephole": (lambda: nn.Recurrent(nn.LSTMPeephole(100, 128)),
                          (32, 50, 100)),
        "conv_lstm_peephole": (lambda: nn.Recurrent(nn.ConvLSTMPeephole(
            8, 16, 3, spatial=(32, 32))), (8, 10, 8, 32, 32)),
        "conv_lstm_peephole_3d": (lambda: nn.Recurrent(
            nn.ConvLSTMPeephole3D(4, 8, 3, spatial=(8, 16, 16))),
            (4, 6, 4, 8, 16, 16)),
        "recurrent_decoder": (lambda: nn.RecurrentDecoder(
            nn.LSTMPeephole(64, 64), 30), (32, 64)),
    }
    gen = torch.Generator().manual_seed(seed + 47)
    rows = {}
    for name, (make, shape) in cases.items():
        m = make().initialize(seed)
        x = torch.randn(shape, generator=gen)
        with torch.inference_mode():
            want = m(x)
            on_card = copy.deepcopy(m).to(dev)
            rows[name] = tensor_rel(on_card(x.to(dev)).cpu(), want)
            if name == "lstm_peephole":
                on_card.cell.peep[2].zero_()
                fault = tensor_rel(on_card(x.to(dev)).cpu(), want)
    print("peephole cells and decoder vs the CPU: "
          + ", ".join(f"{k} {v:.3e}" for k, v in rows.items())
          + f" (tol {NCF_TRAIN_TOL}), output peephole zeroed {fault:.3e} "
          f"[{card}]")
    report["seq_pipe"]["recurrent"] = {**rows, "fault": fault}
    if not (max(rows.values()) <= NCF_TRAIN_TOL < fault):
        raise AssertionError(f"peephole cells: {rows}, fault {fault}")


def seq_pipe_phase(seed, device, card, report):
    """Ring attention, GPipe, MicrobatchedSequential, NeuralCF and the
    rest of the recurrent cells on the card (module docstring, 33)."""
    report["seq_pipe"] = {}
    for name, fn in (
            ("ring", lambda: ring_check(device, card, report)),
            ("gpipe", lambda: gpipe_check(seed, device, card, report)),
            ("microbatched", lambda: microbatched_check(seed, device, card,
                                                        report)),
            ("neural-cf", lambda: ncf_check(seed, device, card, report)),
            ("recurrent", lambda: peephole_check(seed, device, card,
                                                 report))):
        t0 = time.monotonic()
        fn()
        torch.cuda.empty_cache()
        print(f"phase seq-pipe-{name}: {time.monotonic() - t0:.1f} s")


# ------------------------------------------ the seqfile path of ResNet-50
# examples/resnet/train_imagenet.py --seqfiles: the recipe's 1024 samples
# (resnet_data) written as the reference's ImageNet sequence files (keys
# "<name>\n<label>" with 1-based labels, raw HWC uint8 values), two plain,
# one record-compressed, one block-compressed, read back through
# dataset.seqfile.image_samples, and one K=4 block of the recipe fed from
# them against one fed from memory
SEQFILE_FORMATS = (("plain", {}), ("plain", {}),
                   ("record", {"compressed": True}),
                   ("block", {"block_compressed": True}))


def write_recipe_seqfiles(samples, folder):
    """``samples`` as sequence files of the reference's ImageNet layout, a
    quarter of them a file, in order: (paths, bytes, seconds)."""
    from bigdl_tpu_torch.dataset import seqfile
    t0 = time.monotonic()
    n = -(-len(samples) // len(SEQFILE_FORMATS))
    paths, nbytes = [], 0
    for k, (fmt, kw) in enumerate(SEQFILE_FORMATS):
        recs = [(f"n{k * n + i:07d}.JPEG\n{int(s.label) + 1}".encode(),
                 np.ascontiguousarray(s.feature).tobytes())
                for i, s in enumerate(samples[k * n:(k + 1) * n])]
        path = os.path.join(folder, f"part-{k:05d}-{fmt}.seq")
        seqfile.write_seqfile(path, recs, **kw)
        paths.append(path)
        nbytes += os.path.getsize(path)
    return paths, nbytes, time.monotonic() - t0


def record_mismatches(got, want):
    """Records of ``got`` whose image bytes, shape, dtype or label differ
    from ``want``'s (a count; a length mismatch counts as all)."""
    if len(got) != len(want):
        return max(len(got), len(want))
    return sum(not (a.feature.dtype == b.feature.dtype
                    and np.array_equal(a.feature, b.feature)
                    and a.label.dtype == np.asarray(b.label).dtype
                    and a.label == b.label) for a, b in zip(got, want))


def recipe_pipeline(samples):
    B, size = RESNET["batch"], RESNET["size"]
    return DataSet.array(samples) >> MTSampleToMiniBatch(
        B, recipe_augment(size), workers=RESNET["workers"])


def first_batch(samples):
    """The first training batch of the recipe's pipeline over
    ``samples``."""
    it = recipe_pipeline(samples).data(train=True)
    try:
        b = next(it)
    finally:
        it.close()
    return torch.as_tensor(b.input), torch.as_tensor(b.target)


def seqfile_block(init, samples, device, K=RESNET["K"]):
    """One K-step block (K=4) of the recipe (bf16, batch 256) from ``init``
    fed from ``samples`` through the pipeline, under cuDNN's deterministic
    algorithms: (losses, trained model, B1 launches, variant counts, B1
    dtypes, wall seconds)."""
    per_epoch = RESNET["samples"] // RESNET["batch"]
    model = copy.deepcopy(init)
    sound_launch, dtypes = maxpool.launch, []

    def launch(x, *a):
        dtypes.append(x.dtype)
        return sound_launch(x, *a)
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    maxpool.launch = launch
    maxpool.reset_counts()
    try:
        losses, _, opt, wall = resnet_train(
            model, recipe_pipeline(samples), device, K, K, torch.bfloat16,
            per_epoch)
    finally:
        maxpool.launch = sound_launch
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = cudnn
    launches, variants = maxpool.launches, dict(maxpool.variant_launches)
    if opt.state["neval"] != K:
        raise AssertionError(f"the seqfile block ran {opt.state['neval']} "
                             f"steps, not {K}")
    return losses, model, launches, variants, dtypes, wall


def seqfile_phase(seed, device, card, report):
    """The ResNet-50 recipe fed from Hadoop SequenceFiles (module
    docstring, 34).  Returns B1's launches in the file-fed block."""
    from bigdl_tpu_torch.dataset import seqfile
    B, K = RESNET["batch"], RESNET["K"]
    samples, _ = resnet_data()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths, nbytes, write_s = write_recipe_seqfiles(samples, tmp)
        sizes = {os.path.basename(p): os.path.getsize(p) for p in paths}
        t0 = time.monotonic()
        read = seqfile.image_samples(paths)
        read_s = time.monotonic() - t0
        # planted faults: the labels kept 1-based (the recipe's "- 1"
        # dropped), and one byte of one record changed
        one_based = [Sample(np.frombuffer(v, np.uint8).reshape(
            s.feature.shape), np.int32(label)) for s, (label, v) in
            zip(samples, seqfile.seqfiles_to_byte_records(paths))]
    flipped = list(read)
    k = len(flipped) // 2
    img = flipped[k].feature.copy()
    img[img.shape[0] // 2, img.shape[1] // 2, 1] ^= 1
    flipped[k] = Sample(img, flipped[k].label)
    bad = record_mismatches(read, samples)
    faults = {"labels_1_based": record_mismatches(one_based, samples),
              "one_byte_flipped": record_mismatches(flipped, samples)}
    raw_mb = sum(s.feature.nbytes for s in samples) / 1e6
    print(f"seqfile: {len(samples)} recipe samples ({raw_mb:.1f} MB raw) "
          f"written as {len(paths)} files ("
          + ", ".join(f"{k} {v}" for k, v in sizes.items())
          + f" bytes) in {write_s:.2f} s; read and decoded by image_samples"
          f" in {read_s:.2f} s ({len(read) / read_s:.1f} images/s, "
          f"{raw_mb / read_s:.1f} MB/s); records differing from the "
          f"written samples {bad} (planted faults: labels kept 1-based "
          f"{faults['labels_1_based']}, one byte flipped "
          f"{faults['one_byte_flipped']}) [{card}]")
    out.update(files=sizes, bytes=nbytes, write_s=write_s, read_s=read_s,
               read_images_per_s=len(read) / read_s,
               read_mb_per_s=raw_mb / read_s, record_mismatches=bad,
               record_faults=faults)
    if bad or not all(faults.values()):
        raise AssertionError(f"seqfile records: {bad} differ from the "
                             f"written samples; faults {faults}")
    # the recipe's first training batch, from the files and from memory
    fx, fy = first_batch(read)
    mx, my = first_batch(samples)
    # planted fault of the batch and block checks: the records read in
    # the reverse order
    fault_x, _ = first_batch(read[::-1])
    same = torch.equal(fx, mx) and torch.equal(fy, my)
    fault_same = torch.equal(fault_x, mx)
    print(f"seqfile: the pipeline's first batch ({tuple(fx.shape)} "
          f"{fx.dtype}) from the files bitwise the in-memory one: {same} "
          f"(the planted fault, records reversed: {fault_same}) [{card}]")
    out.update(first_batch_bitwise=same, first_batch_fault_bitwise=fault_same)
    if not same or fault_same:
        raise AssertionError(f"seqfile first batch: bitwise {same}, planted "
                             f"fault bitwise {fault_same}")
    # one K=4 block from the files and from memory, bitwise; B1 counted in
    # the file-fed block (the path) only
    init = resnet50(RESNET["classes"], format="NHWC").initialize(seed)
    runs = {name: seqfile_block(init, data, device)
            for name, data in (("files", read), ("memory", samples))}
    # the planted fault's block is one step: its first loss must differ
    runs["fault"] = seqfile_block(init, read[::-1], device, K=1)
    (flosses, fmodel, launches, variants, dtypes, fwall), \
        (mlosses, mmodel, _, _, _, mwall) = runs["files"], runs["memory"]
    same = flosses == mlosses and params_equal(fmodel, mmodel)
    fault_same = runs["fault"][0] == mlosses[:1]
    print(f"seqfile: one K={K} block of resnet50 NHWC bf16 batch {B} fed "
          f"from the files: losses "
          + ", ".join(f"{v:.6f}" for v in flosses)
          + f", bitwise the memory-fed block's (losses and weights) {same} "
          f"(the planted fault's losses bitwise {fault_same}); B1 "
          f"launches {launches} ({variants}), dtypes {sorted(set(map(str, dtypes)))}"
          f"; block wall {fwall:.2f} s from the files, {mwall:.2f} s from "
          f"memory ({K * B / fwall:.1f} / {K * B / mwall:.1f} images/s, a "
          f"warm process, pipeline and steps) [{card}]")
    out.update(losses=flosses, memory_losses=mlosses, bitwise=same,
               fault_bitwise=fault_same, launches=launches,
               variant_launches=variants, block_wall_s=fwall,
               memory_block_wall_s=mwall,
               block_images_per_s=K * B / fwall,
               memory_block_images_per_s=K * B / mwall)
    report["seqfile"] = out
    if not same or fault_same:
        raise AssertionError(f"seqfile block: bitwise {same}, planted fault "
                             f"bitwise {fault_same}")
    if launches != K or variants["tiled_nhwc"] != K \
            or set(dtypes) != {torch.bfloat16}:
        raise AssertionError(f"seqfile block: B1 launched {launches} times "
                             f"({variants}, {set(dtypes)}), want {K} bf16 "
                             f"tiled_nhwc")
    del runs, fmodel, mmodel
    return launches


# ------------------------------------------------------ the rest of nn/
# Detection at the sizes its users run: SSD300's six prior maps (Liu et al.
# 2016: 38^2, 19^2, 10^2, 5^2, 3^2, 1^2 cells, 4/6/6/6/4/4 priors, 8732 in
# all) and its output head at VOC's 21 classes; Faster R-CNN VGG16 at test
# time (Ren et al. 2015: RPN pre-NMS 6000, post-NMS 300, ratios (0.5, 1, 2),
# scales (8, 16, 32), stride 16, conv5 (1, 512, 38, 50) for a 600x800
# image, RoI pooling 7x7 at 1/16, 100 detections an image); the Tree-LSTM
# sentiment recipe (examples/treeLSTMSentiment/train.py) and a
# BinaryTreeLSTM at Tai et al.'s SST widths (embed 300, hidden 150)
TAIL = {"ssd_batch": 8, "classes": 21, "nms_topk": 400, "keep_topk": 200,
        "frcnn_map": (38, 50), "frcnn_channels": 512, "im_info": (600.0,
        800.0), "pre_nms": 6000, "post_nms": 300, "frcnn_dets": 100,
        "roi_cpu": 64, "trees": 256, "tree_leaves": 6, "tree_vocab": 40,
        "tree_embed": 16, "tree_hidden": 32, "tree_lr": 0.02,
        "tree_steps": 60, "sst_trees": 25, "sst_leaves": (5, 50),
        "sst_embed": 300, "sst_hidden": 150, "loop_steps": 20,
        "lenet_f16_steps": 300}
# (feature map side, min size, max size, aspect ratios, step) of SSD300
SSD300_MAPS = ((38, 30, 60, (2,), 8), (19, 60, 111, (2, 3), 16),
               (10, 111, 162, (2, 3), 32), (5, 162, 213, (2, 3), 64),
               (3, 213, 264, (2,), 100), (1, 264, 315, (2,), 300))
# the card against the CPU: decoded boxes (a share of their largest
# coordinate), the layers and the loop step by step (losses and
# gradients as a share of each array's largest), the tree recipe step by
# step against step 0's loss and gradient norms; above the sound readings
# (f32 on both, TF32 off) and below the planted faults every run measures
TAIL_TOL = 1e-4


def tail_reading(label, sound, faults, card, report, tol=TAIL_TOL,
                 what="max|d|/max|ref|"):
    """Print and record a card-vs-CPU reading and its planted faults;
    fail unless the reading is within ``tol`` and every fault above it."""
    print(f"tail {label}: {what} {sound:.3e} (limit {tol:g}); planted "
          f"faults " + ", ".join(f"{k} {v:.3e}" for k, v in faults.items())
          + f" [{card}]")
    report.setdefault("tail", {}).setdefault("readings", {})[label] = {
        "reading": sound, "limit": tol, "planted_faults": faults}
    if not (np.isfinite(sound) and sound <= tol):
        raise AssertionError(f"tail {label}: reading {sound} over {tol}")
    low = {k: v for k, v in faults.items() if not v > tol}
    if low:
        raise AssertionError(f"tail {label}: planted faults {low} within "
                             f"{tol}")


def same_selection(label, got, want, fault, card, report):
    """The selection stage on the card against the CPU on the same decoded
    boxes: bitwise, while a planted fault is not."""
    same = all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    fault_same = all(torch.equal(a.cpu(), b) for a, b in zip(fault, want))
    print(f"tail {label} selection on the card's decoded boxes, card vs "
          f"CPU: bitwise {same} (planted fault bitwise {fault_same}); "
          f"valid {int(got[1].sum())} of {got[1].numel()} [{card}]")
    report.setdefault("tail", {}).setdefault("selections", {})[label] = {
        "bitwise": same, "fault_bitwise": fault_same,
        "valid": int(got[1].sum())}
    if not same or fault_same:
        raise AssertionError(f"tail {label}: selection bitwise {same}, "
                             f"planted fault bitwise {fault_same}")


def ssd300_priors(device, offset=0.5):
    priors = []
    for side, mn, mx, ars, step in SSD300_MAPS:
        pb = nn.PriorBox([float(mn)], [float(mx)], [float(a) for a in ars],
                         variances=[0.1, 0.1, 0.2, 0.2], offset=offset,
                         img_size=300, step=float(step))
        priors.append(pb(torch.empty((1, 1, side, side), device=device)))
    return torch.cat(priors, 2)


def timed(fn):
    """(milliseconds of one call on the card, event-timed, after a
    warm-up call; its result)."""
    y = fn()
    torch.cuda.synchronize()
    return cuda_ms(fn, budget_ms=200.0), y


def detection_checks(seed, device, card, report):
    """SSD300 priors and output head, Faster R-CNN VGG16's proposals, RoI
    pooling and output head on the card against the CPU (module
    docstring, 35)."""
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(seed + 35)
    out = {}
    # SSD300 priors: every coordinate against the CPU's
    priors = ssd300_priors(device)
    P = priors.shape[2] // 4
    if P != 8732:
        raise AssertionError(f"SSD300 has {P} priors, not 8732")
    want = ssd300_priors(cpu)
    tail_reading("ssd300 priors", max_share(priors.cpu(), want),
                 {"offset_0": max_share(ssd300_priors(cpu, 0.0), want)},
                 card, report)
    prior_ms, _ = timed(lambda: ssd300_priors(device))
    # SSD300's head at VOC's classes: the decode within rounding of the
    # CPU's, then the selection (batched NMS, the global cut) on the card's
    # decoded boxes bitwise the CPU's
    N, C = TAIL["ssd_batch"], TAIL["classes"]
    loc = torch.randn(N, P * 4, generator=gen) * 0.5
    conf = torch.softmax(torch.randn(N, P, C, generator=gen) * 2.0,
                         -1).reshape(N, -1)
    det = nn.DetectionOutputSSD(C, nms_topk=TAIL["nms_topk"],
                                keep_topk=TAIL["keep_topk"])
    loc_d, conf_d = loc.to(device), conf.to(device)
    boxes = det.decode(loc_d, priors)
    swapped = torch.cat([want[:, :1], want[:, 1:].reshape(1, 1, -1, 4)
                         .flip(-1).reshape(1, 1, -1)], 1)
    want_boxes = det.decode(loc, want)
    tail_reading("ssd decode", max_share(boxes.cpu(), want_boxes),
                 {"variances_reversed": max_share(det.decode(loc, swapped),
                                                  want_boxes)}, card, report)
    got = det.select(boxes, conf_d)
    # planted fault: class 1 taken for the background, class 0 kept
    fault = nn.DetectionOutputSSD(C, bg_label=1, nms_topk=TAIL["nms_topk"],
                                  keep_topk=TAIL["keep_topk"]).select(
        boxes, conf_d)
    same_selection("ssd", got, det.select(boxes.cpu(), conf), fault, card,
                   report)
    ssd_ms, _ = timed(lambda: det((loc_d, conf_d, priors)))
    ssd_cpu_s = time.monotonic()
    det((loc, conf, want))
    ssd_cpu_s = time.monotonic() - ssd_cpu_s
    out["ssd"] = {"priors": P, "priors_ms": prior_ms, "ms": ssd_ms,
                  "cpu_s": ssd_cpu_s, "valid": int(got[1].sum())}
    print(f"tail ssd300: {P} priors in {prior_ms:.3f} ms, the output head "
          f"(batch {N}, {C} classes, nms_topk {TAIL['nms_topk']}, keep_topk "
          f"{TAIL['keep_topk']}) {ssd_ms:.3f} ms a call on the card, "
          f"{ssd_cpu_s:.2f} s on the CPU [{card}]")
    # Faster R-CNN VGG16 at test time
    H, W = TAIL["frcnn_map"]
    ratios, scales = (0.5, 1.0, 2.0), (8.0, 16.0, 32.0)
    A = len(ratios) * len(scales)
    scores = torch.rand(1, 2 * A, H, W, generator=gen)
    deltas = torch.randn(1, 4 * A, H, W, generator=gen) * 0.1
    im_info = torch.tensor([[*TAIL["im_info"], 1.0, 1.0]])
    prop = nn.Proposal(TAIL["pre_nms"], TAIL["post_nms"], ratios, scales,
                       feat_stride=16.0)
    x_d = (scores.to(device), deltas.to(device), im_info.to(device))
    proposals, fg = prop.decode(x_d)
    want_p, _ = prop.decode((scores, deltas, im_info))
    off_anchor = nn.Proposal(TAIL["pre_nms"], TAIL["post_nms"], ratios,
                             scales, feat_stride=8.0)
    tail_reading("proposal decode", max_share(proposals.cpu(), want_p),
                 {"stride_8": max_share(off_anchor.decode(
                     (scores, deltas, im_info))[0], want_p)}, card, report)
    got = prop.select(proposals, fg)
    fault = nn.Proposal(TAIL["pre_nms"], TAIL["post_nms"], ratios, scales,
                        nms_thresh=0.5).select(proposals, fg)
    same_selection("proposal", got, prop.select(proposals.cpu(), fg.cpu()),
                   fault, card, report)
    prop_ms, _ = timed(lambda: prop(x_d))
    rois = got[0]
    # RoI pooling over conv5: bitwise the CPU's on the first RoIs
    feat = torch.randn(1, TAIL["frcnn_channels"], H, W, generator=gen)
    feat_d = feat.to(device)
    pool = nn.RoiPooling(7, 7, 1.0 / 16)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pooled = pool((feat_d, rois))
    torch.cuda.synchronize()
    roi_peak = torch.cuda.max_memory_allocated() - base
    k = TAIL["roi_cpu"]
    want_pool = pool((feat, rois[:k].cpu()))
    same = torch.equal(pooled[:k].cpu(), want_pool)
    fault_same = torch.equal(nn.RoiPooling(7, 7, 1.0 / 8)(
        (feat_d, rois[:k])).cpu(), want_pool)
    roi_ms, _ = timed(lambda: pool((feat_d, rois)))
    print(f"tail roi pooling 7x7 at 1/16 over {tuple(feat.shape)}, "
          f"{rois.shape[0]} RoIs: {tuple(pooled.shape)}, the first {k} "
          f"bitwise the CPU's {same} (planted fault, scale 1/8: {fault_same}"
          f"); {roi_ms:.3f} ms a call, peak {roi_peak / 2 ** 30:.3f} GiB "
          f"above its inputs (chunks of at most "
          f"{pool.chunk_bytes / 2 ** 30:.0f} GiB) [{card}]")
    if not same or fault_same or not torch.isfinite(pooled).all():
        raise AssertionError(f"roi pooling: bitwise {same}, fault "
                             f"{fault_same}")
    if roi_peak > 3 * 2 ** 30:
        raise AssertionError(f"roi pooling peaked at {roi_peak} bytes")
    # the Faster R-CNN head over the proposals
    R = rois.shape[0]
    fdeltas = torch.randn(R, 4 * C, generator=gen) * 0.1
    fscores = torch.softmax(torch.randn(R, C, generator=gen) * 2.0, -1)
    head = nn.DetectionOutputFrcnn(n_classes=C,
                                   max_per_image=TAIL["frcnn_dets"])
    fd_d, fs_d, info_d = fdeltas.to(device), fscores.to(device), x_d[2]
    decoded = head.decode(info_d, rois, fd_d)
    want_dec = head.decode(im_info, rois.cpu(), fdeltas)
    tail_reading("frcnn decode", max_share(decoded.cpu(), want_dec),
                 {"deltas_x_y_swapped": max_share(head.decode(
                     im_info, rois.cpu(), fdeltas.reshape(R, C, 4)[
                         ..., [1, 0, 3, 2]].reshape(R, -1)), want_dec)},
                 card, report)
    got = head.select(decoded, fs_d)
    # planted fault: each class scored by its neighbour's column
    fault = head.select(decoded, fs_d.roll(1, 1))
    same_selection("frcnn", got, head.select(decoded.cpu(), fscores), fault,
                   card, report)
    frcnn_ms, _ = timed(lambda: head((info_d, rois, fd_d, fs_d)))
    out["frcnn"] = {"proposal_ms": prop_ms, "roi_pool_ms": roi_ms,
                    "roi_pool_peak_bytes": roi_peak, "head_ms": frcnn_ms,
                    "proposals_valid": int(got[1].sum())}
    print(f"tail faster r-cnn vgg16: proposal (pre {TAIL['pre_nms']}, post "
          f"{TAIL['post_nms']}, {H}x{W}x{A} anchors) {prop_ms:.3f} ms, RoI "
          f"pooling {roi_ms:.3f} ms, the output head ({C} classes, "
          f"{TAIL['frcnn_dets']} an image) {frcnn_ms:.3f} ms a call [{card}]")
    return out


def tree_sentiment_data(n, n_leaves, vocab, seed=0):
    """The recipe's synthetic right-leaning trees
    (examples/treeLSTMSentiment/train.py): tokens (n, n_leaves), trees
    (n, 2 n_leaves - 1, 3), labels the majority leaf polarity."""
    rng = np.random.default_rng(seed)
    n_nodes = 2 * n_leaves - 1
    tree = np.zeros((n_nodes, 3), np.float32)
    for i in range(n_leaves):
        tree[i] = [0, 0, i + 1]
    nxt, prev = n_leaves, n_leaves
    for k in range(n_leaves - 1):
        tree[nxt] = [n_leaves - 1 - k, prev, 0]
        prev = nxt + 1
        nxt += 1
    tokens = rng.integers(0, vocab, (n, n_leaves))
    labels = (np.where(tokens < vocab // 2, 1, -1).sum(1) > 0).astype(
        np.int64)
    return tokens, np.tile(tree[None], (n, 1, 1)), labels


class TreeSentiment(nn.Module):
    """The recipe's model: embedding, BinaryTreeLSTM, a Linear on the root
    state, log-softmax."""

    def __init__(self, vocab, embed, hidden):
        super().__init__("TreeSentiment")
        self.embed = nn.LookupTable(vocab, embed)
        self.tree = nn.BinaryTreeLSTM(embed, hidden)
        self.head = nn.Linear(hidden, 2)

    def forward(self, x):
        tokens, trees = x
        states = self.tree((self.embed(tokens), trees))
        return torch.log_softmax(self.head(states[:, -1]), -1)


def nll(logp, y):
    return -logp.gather(1, y[:, None]).mean()


def full_batch_adam(model, batch, steps, lr):
    """Full-batch Adam with nll on ``batch``'s device, ``model`` trained in
    place: (each step's loss, :func:`recording`'s steps)."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    x, y = batch
    adam = RecordingAdam(learning_rate=lr)
    state = adam.init_state(params)
    losses = []
    for i in range(steps):
        loss = nll(model(x), y)
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(loss.item())
        adam.update(dict(zip(params, grads)), params, state, lr, i)
    return losses, adam.steps


def nll_cpu_step(init, params, batch):
    """``cpu_step`` of :func:`wd_step_reading` for :func:`full_batch_adam`:
    the loss and gradients of one step on the CPU from ``params``."""
    m = copy.deepcopy(init)
    with torch.no_grad():
        for k, p in m.named_parameters():
            p.copy_(params[k])
            p.requires_grad_(True)
    loss = nll(m(batch[0]), batch[1])
    loss.backward()
    return loss.item(), {k: p.grad.double() for k, p in m.named_parameters()}


class SwappedComposer(nn.BinaryTreeLSTM):
    """A planted fault: the composer's left and right children swapped."""

    def _compose(self, lc, lh, rc, rh):
        return super()._compose(rc, rh, lc, lh)


def tree_checks(seed, device, card, report):
    """The Tree-LSTM sentiment recipe on the card step by step against the
    CPU, and a BinaryTreeLSTM at SST widths (module docstring, 35)."""
    cpu = torch.device("cpu")
    t = TAIL
    tokens, trees, labels = tree_sentiment_data(
        t["trees"], t["tree_leaves"], t["tree_vocab"])
    batch = ((torch.from_numpy(tokens), torch.from_numpy(trees)),
             torch.from_numpy(labels))
    batch_d = ((batch[0][0].to(device), batch[0][1].to(device)),
               batch[1].to(device))

    init = TreeSentiment(t["tree_vocab"], t["tree_embed"],
                         t["tree_hidden"]).initialize(seed)
    batches = [batch] * t["tree_steps"]

    def card_run(tree=None):
        model = copy.deepcopy(init)
        if tree is not None:
            tree.load_state_dict(init.tree.state_dict())
            model.tree = tree
        model.to(device)
        return (model, *full_batch_adam(model, batch_d, t["tree_steps"],
                                        t["tree_lr"]))

    t0 = time.monotonic()
    model, losses, steps = card_run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    with torch.no_grad():
        acc = (model(batch_d[0]).argmax(-1) == batch_d[1]).float().mean()

    def reading(losses, steps):
        return wd_step_reading(losses, steps, init, batches, nll_cpu_step,
                               norm_share, first_scale=True)
    sound, worst = reading(losses, steps)
    faults = {name: reading(*card_run(tree)[1:])[0] for name, tree in (
        ("composer_sides_swapped", SwappedComposer(t["tree_embed"],
                                                   t["tree_hidden"])),
        ("no_output_gate", nn.BinaryTreeLSTM(
            t["tree_embed"], t["tree_hidden"], gate_output=False)))}
    print(f"tail tree-lstm recipe, the largest shares (share, what): "
          f"{worst} [{card}]")
    tail_reading(f"tree-lstm recipe, step by step ({len(steps)} steps)",
                 sound, faults, card, report,
                 what="||d|| / ||step 0's ref||")
    print(f"tail tree-lstm sentiment recipe: {t['trees']} trees of "
          f"{t['tree_leaves']} leaves, embed {t['tree_embed']}, hidden "
          f"{t['tree_hidden']}, Adam {t['tree_lr']}, {t['tree_steps']} "
          f"full-batch steps in {wall:.2f} s ({wall / t['tree_steps'] * 1e3:.2f}"
          f" ms a step); loss {losses[0]:.4f} -> {losses[-1]:.4f}, train "
          f"accuracy {float(acc):.4f} [{card}]")
    out = {"recipe": {"losses": losses, "accuracy": float(acc),
                      "ms_per_step": wall / t["tree_steps"] * 1e3}}
    if not (losses[-1] < 0.5 * losses[0] and float(acc) > 0.9):
        raise AssertionError(f"tree recipe did not learn: {losses[-1]}, "
                             f"{float(acc)}")
    # SST widths: random binary trees of 5-50 leaves, padded
    rng = np.random.default_rng(seed + 36)
    lens = rng.integers(*t["sst_leaves"], t["sst_trees"])
    L = int(lens.max())
    sst = np.zeros((t["sst_trees"], 2 * L - 1, 3), np.float32)
    for b, n in enumerate(lens):
        rows = [[0, 0, i + 1] for i in range(n)]
        live = list(range(1, n + 1))
        while len(live) > 1:
            i = int(rng.integers(0, len(live) - 1))
            rows.append([live[i], live[i + 1], 0])
            live[i:i + 2] = [len(rows)]
        sst[b, :len(rows)] = rows
    emb = torch.randn(t["sst_trees"], L, t["sst_embed"],
                      generator=torch.Generator().manual_seed(seed))
    cot = torch.randn(t["sst_trees"], 2 * L - 1, t["sst_hidden"],
                      generator=torch.Generator().manual_seed(seed + 1))
    sst_t = torch.from_numpy(sst)
    levels = len(tree_plan(sst, L)[2])

    def grads_of(m, dev):
        m = m.to(dev)
        for p in m.parameters():
            p.requires_grad_(True)
        e = emb.to(dev).requires_grad_(True)
        y = m((e, sst_t.to(dev)))
        gs = torch.autograd.grad((y * cot.to(dev)).sum(),
                                 [e, *m.parameters()])
        return [y.detach().cpu()] + [g.cpu() for g in gs]

    base = nn.BinaryTreeLSTM(t["sst_embed"], t["sst_hidden"]).initialize(
        seed)
    want = grads_of(copy.deepcopy(base), cpu)
    got = grads_of(copy.deepcopy(base), device)
    swapped = SwappedComposer(t["sst_embed"], t["sst_hidden"])
    swapped.load_state_dict(base.state_dict())
    fault = grads_of(swapped, device)
    tail_reading("binary tree-lstm at sst widths",
                 max(max_share(a, b) for a, b in zip(got, want)),
                 {"composer_sides_swapped": max(
                     max_share(a, b) for a, b in zip(fault, want))},
                 card, report)
    m_d = copy.deepcopy(base).to(device)
    for p in m_d.parameters():
        p.requires_grad_(True)
    e_d, s_d, c_d = emb.to(device).requires_grad_(True), sst_t.to(device), \
        cot.to(device)
    fwd_ms, _ = timed(lambda: m_d((e_d, s_d)))
    both_ms, _ = timed(lambda: torch.autograd.grad(
        (m_d((e_d, s_d)) * c_d).sum(), [e_d, *m_d.parameters()]))
    print(f"tail binary tree-lstm at sst widths: {t['sst_trees']} trees of "
          f"{int(lens.min())}-{L} leaves ({2 * L - 1} rows), embed "
          f"{t['sst_embed']}, hidden {t['sst_hidden']}: forward "
          f"{fwd_ms:.3f} ms, forward and backward {both_ms:.3f} ms on the "
          f"card ({levels} composer levels) [{card}]")
    out["sst"] = {"forward_ms": fwd_ms, "forward_backward_ms": both_ms,
                  "levels": levels, "max_leaves": L}
    return out


class LoopStep(nn.Module):
    """``(i, h) -> (i + 1, tanh(lin(h)) * exp(1000 relu(i - 3.5)))``: the
    identity gain while the loop lives (i < 4), inf on a dead trip."""

    def __init__(self, width):
        super().__init__("LoopStep")
        self.lin = nn.Linear(width, width)

    def forward(self, c):
        i, h = c
        grow = torch.exp(1000.0 * torch.relu(i.float() - 3.5))
        return i + 1, torch.tanh(self.lin(h)) * grow


def loop_model(width=16, trips=4, max_trip=8):
    inp = nn.Input()
    carry = nn.Lambda(lambda x: (torch.zeros((), dtype=torch.long,
                                             device=x.device), x))(inp)
    looped = nn.While(lambda c: c[0] < trips, LoopStep(width),
                      max_trip_count=max_trip)(carry)
    head = nn.Linear(width, 2)(nn.Lambda(lambda c: c[1])(looped))
    return nn.DynamicGraph([inp], [nn.LogSoftMax()(head)])


class MaskedLoop(nn.While):
    """A planted fault: every trip up to max_trip_count runs, the dead
    trips' results masked by a select."""

    def forward(self, x):
        for _ in range(self.max_trip_count):
            live = self.cond(x)
            out = self.body(x)
            x = tuple(torch.where(live, o, c) for o, c in zip(out, x))
        return x


def loop_checks(seed, device, card, report):
    """A While trained on the card whose body diverges after its exit
    (module docstring, 35)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (256, 16)).astype(np.float32))
    y = (x.sum(1) > 0).long()
    batch_d = (x.to(device), y.to(device))

    init = loop_model().initialize(seed)
    losses, steps = full_batch_adam(copy.deepcopy(init).to(device), batch_d,
                                    TAIL["loop_steps"], 0.01)
    finite = all(bool(torch.isfinite(g).all()) for _, grads in steps
                 for g in grads.values())
    masked = copy.deepcopy(init)
    next(m for m in masked.modules()
         if isinstance(m, nn.While)).__class__ = MaskedLoop
    _, fault = full_batch_adam(masked.to(device), batch_d, 1, 0.01)
    fault_finite = all(bool(torch.isfinite(g).all())
                       for g in fault[0][1].values())
    print(f"tail while loop (max_trip_count 8, exit after 4 trips, a body "
          f"that is inf on a dead trip) trained {TAIL['loop_steps']} Adam "
          f"steps on the card: gradients finite {finite}, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (the planted fault, dead "
          f"trips masked: gradients finite {fault_finite}) [{card}]")
    tail_reading("while loop, step by step", wd_step_reading(
        losses, steps, init, [(x, y)] * len(steps), nll_cpu_step)[0],
        {"dead_trips_masked": float("inf") if not fault_finite else 0.0},
        card, report)
    if not finite or fault_finite or not losses[-1] < losses[0]:
        raise AssertionError(f"while loop: gradients finite {finite}, fault "
                             f"finite {fault_finite}, losses {losses}")
    return {"losses": losses}


def _t(gen, *shape):
    return torch.randn(*shape, generator=gen)


# the volumetric and extras layers at small sizes: (factory, input maker)
TAIL_LAYERS = {
    "VolumetricConvolution": (lambda: nn.VolumetricConvolution(
        3, 8, 3, 3, 3, 1, 1, 1, 1, 1, 1), lambda g: _t(g, 2, 3, 8, 16, 16)),
    "VolumetricMaxPooling": (lambda: nn.VolumetricMaxPooling(
        2, 3, 3, 2, 2, 2, 1, 1, 1), lambda g: _t(g, 2, 4, 8, 15, 15)),
    "VolumetricAveragePooling": (lambda: nn.VolumetricAveragePooling(
        3, 3, 3, 2, 2, 2, 1, 1, 1, count_include_pad=False),
        lambda g: _t(g, 2, 4, 8, 15, 15)),
    "VolumetricFullConvolution": (lambda: nn.VolumetricFullConvolution(
        4, 3, 2, 3, 3, 2, 2, 2, 0, 1, 1, 1, 0, 0),
        lambda g: _t(g, 2, 4, 4, 8, 8)),
    "LocallyConnected2D": (lambda: nn.LocallyConnected2D(
        3, 12, 12, 8, 3, 3, 1, 1, 1, 1), lambda g: _t(g, 4, 3, 12, 12)),
    "LocallyConnected1D": (lambda: nn.LocallyConnected1D(20, 8, 6, 3, 2),
                           lambda g: _t(g, 4, 20, 8)),
    "SpatialConvolutionMap": (lambda: nn.SpatialConvolutionMap(
        [[0, 0], [1, 0], [1, 1], [2, 1], [0, 2], [2, 2]], 5, 5),
        lambda g: _t(g, 4, 3, 16, 16)),
    "SpatialDilatedConvolution": (lambda: nn.SpatialDilatedConvolution(
        4, 8, 3, 3, 1, 1, 2, 2, 2, 2), lambda g: _t(g, 4, 4, 16, 16)),
    "SpatialContrastiveNormalization": (
        lambda: nn.SpatialContrastiveNormalization(3),
        lambda g: _t(g, 2, 3, 20, 20)),
    "SpatialWithinChannelLRN": (lambda: nn.SpatialWithinChannelLRN(5),
                                lambda g: _t(g, 2, 3, 16, 16)),
    "ResizeBilinear": (lambda: nn.ResizeBilinear(23, 17),
                       lambda g: _t(g, 2, 3, 10, 12)),
    "UpSampling3D": (lambda: nn.UpSampling3D((2, 2, 2)),
                     lambda g: _t(g, 2, 2, 3, 4, 4)),
    "Bilinear": (lambda: nn.Bilinear(16, 12, 8),
                 lambda g: (_t(g, 32, 16), _t(g, 32, 12))),
    "Cosine": (lambda: nn.Cosine(16, 8), lambda g: _t(g, 32, 16)),
    "Euclidean": (lambda: nn.Euclidean(16, 8), lambda g: _t(g, 32, 16)),
    "CosineDistance": (lambda: nn.CosineDistance(),
                       lambda g: (_t(g, 32, 16), _t(g, 32, 16))),
    "MM": (lambda: nn.MM(False, True),
           lambda g: (_t(g, 4, 8, 16), _t(g, 4, 12, 16))),
    "MixtureTable": (lambda: nn.MixtureTable(),
                     lambda g: (torch.softmax(_t(g, 8, 4), -1),
                                _t(g, 8, 4, 16))),
    "Bottle": (lambda: nn.Bottle(nn.Linear(16, 8)),
               lambda g: _t(g, 4, 10, 16)),
    "MapTable": (lambda: nn.MapTable(nn.Linear(16, 8)),
                 lambda g: (_t(g, 4, 16), _t(g, 4, 16))),
}


class HalfPixelResize(nn.ResizeBilinear):
    """A planted fault: torch's half-pixel bilinear resize."""

    def forward(self, x):
        return torch.nn.functional.interpolate(
            x, self.out_hw, mode="bilinear", align_corners=False)


def layer_grads(m, x, dev, seed):
    """The layer's output and the gradients of ``sum(out * cot)`` with
    respect to its float inputs and weights, on ``dev``, on the host."""
    m = copy.deepcopy(m).to(dev).eval()
    for p in m.parameters():
        p.requires_grad_(True)
    xs = tuple(a.to(dev).requires_grad_(True) for a in x) \
        if isinstance(x, tuple) else x.to(dev).requires_grad_(True)
    y = m(xs)
    y = torch.stack(y) if isinstance(y, tuple) else y
    cot = torch.randn(y.shape, generator=torch.Generator().manual_seed(
        seed)).to(dev)
    leaves = [*(xs if isinstance(xs, tuple) else (xs,)), *m.parameters()]
    gs = torch.autograd.grad((y * cot).sum(), leaves)
    return [y.detach().cpu()] + [g.cpu() for g in gs]


def layer_checks(seed, device, card, report):
    """Each volumetric and extras layer of TAIL_LAYERS on the card against
    the CPU, forward and backward, same weights and inputs."""
    cpu = torch.device("cpu")
    worst, rows = 0.0, {}
    for name, (make, inputs) in TAIL_LAYERS.items():
        gen = torch.Generator().manual_seed(seed + len(rows))
        m, x = make().initialize(seed), inputs(gen)
        got, want = layer_grads(m, x, device, seed), layer_grads(m, x, cpu,
                                                                 seed)
        rows[name] = max(max_share(a, b) for a, b in zip(got, want))
        worst = max(worst, rows[name])
    x = TAIL_LAYERS["ResizeBilinear"][1](torch.Generator().manual_seed(0))
    want = layer_grads(nn.ResizeBilinear(23, 17), x, cpu, seed)
    fault = layer_grads(HalfPixelResize(23, 17), x, device, seed)
    print("tail layers card vs CPU (forward and gradients, a share of "
          "the largest): " + ", ".join(f"{k} {v:.1e}" for k, v in
                                       rows.items()) + f" [{card}]")
    tail_reading(f"{len(rows)} volumetric and extras layers", worst,
                 {"half_pixel_resize": max_share(fault[0], want[0])}, card,
                 report)
    return rows


def lenet_f16_run(seed, device, card, report):
    """LeNet-5 trained in f16 (``set_compute_dtype(torch.float16)``) on the
    card: TAIL["lenet_f16_steps"] steps of the recipe's pipeline; its
    pools on B1 in f16, tiled_nchw, 2 launches a step.  Returns B1's
    launches."""
    train, _ = lenet_data()
    steps, B = TAIL["lenet_f16_steps"], LENET["batch"]
    model = lenet5(10).initialize(seed)
    losses, clock, dtypes = [], [], []
    sound = maxpool.launch

    def launch(x, *a):
        dtypes.append(x.dtype)
        return sound(x, *a)

    class Recording(LocalOptimizer):
        def _log_train_iteration(self, lr):
            losses.append(self.state["loss"])
            clock.append(time.perf_counter())

    maxpool.launch = launch
    maxpool.reset_counts()
    try:
        (Recording(model, lenet_pipeline(train, True, steps * B),
                   nn.ClassNLLCriterion(), device=device)
         .set_optim_method(lenet_sgd()).set_compute_dtype(torch.float16)
         .set_end_when(optim.max_iteration(steps)).optimize())
    finally:
        maxpool.launch = sound
    launches, variants = maxpool.launches, dict(maxpool.variant_launches)
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    ms = (clock[-1] - clock[10]) / (len(clock) - 11) * 1e3
    print(f"tail lenet5 f16: {steps} steps of batch {B}, loss {first:.4f} "
          f"-> {last:.4f} (means of the first and last 10), {ms:.3f} ms a "
          f"step; B1 launches {launches} ({variants}), dtypes "
          f"{sorted(set(map(str, dtypes)))} [{card}]")
    report.setdefault("tail", {})["lenet_f16"] = {
        "losses": losses, "ms_per_step": ms, "launches": launches,
        "variant_launches": variants}
    if not (np.isfinite(losses).all() and last < 0.5 * first):
        raise AssertionError(f"lenet f16 did not learn: {first} -> {last}")
    if launches != 2 * steps or variants["tiled_nchw"] != 2 * steps \
            or set(dtypes) != {torch.float16}:
        raise AssertionError(f"lenet f16: B1 {launches} launches "
                             f"({variants}, {set(dtypes)}) in {steps} steps")
    return launches


def f16_pool_phase(device, card, report):
    """B1 in f16 at every case of F16_POOL_CASES, bitwise against its plain
    version, then at the stem and LeNet's pools: its time beside the
    bound, the plain version and the library (module docstring, 35; run
    early, while the profiler keeps its sessions).  Returns the rows."""
    gen = torch.Generator(device=device).manual_seed(2718)
    for name in F16_POOL_CASES:
        pool_case_check(pool_case(name), gen, device)
    rows = {name: pool_row(pool_case(name), gen, device, card)
            for name in ("stem_nhwc_f16", "lenet_pool1_nchw_f16",
                         "lenet_pool2_nchw_f16")}
    report["f16_pool"] = rows
    return rows


def tail_phase(seed, device, card, report):
    """The rest of nn/ on the card (module docstring, 35).  Returns B1's
    launches in the f16 LeNet run."""
    out = {}
    for label, check in (("detection", detection_checks),
                         ("tree", tree_checks), ("loop", loop_checks),
                         ("layers", layer_checks)):
        t0 = time.monotonic()
        out[label] = check(seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase tail-{label}: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    launches = lenet_f16_run(seed, device, card, report)
    print(f"phase tail-f16: {time.monotonic() - t0:.1f} s")
    report.setdefault("tail", {}).update(out)
    return launches



# ------------------------------------------------------------ f16 compute
# The f16 forms of B2f, B2b, B3 and B4 (module docstring, 36).  B3 in f16:
# the census wide path (its forward: an f16 table and f16 values; its table
# gradient: the f32 cotangent and f16 values), D 16 with f16 values and
# with f32 ones, a ragged D with f16 values.
F16_BAG_CASES = [
    ("census_f16", 8192, 100_000, 1, 65_536, torch.float16, torch.float16,
     "census"),
    ("d16_f16", 2048, 50_000, 16, 16_384, torch.float16, torch.float16,
     "unsorted"),
    ("d16_f16_table_f32_values", 2048, 50_000, 16, 16_384, torch.float16,
     torch.float32, "unsorted"),
    ("d129_ragged_f16", 1000, 5000, 129, 8000, torch.float16, torch.float16,
     "unsorted"),
]
# the f16 paths step by step (wd_step_reading, norm shares against step
# 0's loss and gradients), PTB-medium against its plain cell on the card,
# Wide&Deep against the CPU: each limit above the sound reading and below
# the planted faults that every run measures and requires to exceed it.
# PTB-medium is not read against the CPU: the CPU's f16 embedding gradient
# adds in f16, which no cell fault stands out from, and a CPU f16 step
# takes about 20 s on the card's host.  Readings on an H100
# 80GB HBM3 at 700 W (deterministic: a redo with the kernels reads 0): PTB
# sound 9.485e-04, faults 6.127e-03 and 2.677e-03 (a bf16-rounded h', c'
# or dz, 1.657e-03 / 1.619e-03, lies too near the sound reading to plant;
# the f16 kernel check's one-ulp limit, 1e-3 against bf16's 8e-3, holds
# that; probes/f16_ptb_reading.py); Wide&Deep sound 2.231e-03, faults
# 7.718e-03-8.431e-03.
F16 = {"ptb_tol": 1.6e-3, "wd_tol": 5e-3}


def dtype_spy(module, name, record):
    """Replace ``module.name`` by a wrapper that appends the dtypes of its
    tensor arguments to ``record``; returns the sound function."""
    sound = getattr(module, name)

    def spy(*args, **kw):
        record.append(tuple(a.dtype for a in args
                            if isinstance(a, torch.Tensor)))
        return sound(*args, **kw)
    setattr(module, name, spy)
    return sound


def f16_gemm_phase(shapes, device, card):
    """B4 with f16 rows at every distinct GEMM of the batch-32 ResNet-50
    forward, both modes (weight_only: the f16 rows as they are, the mma
    form at the stem's K=147 and the one-pass f16 ``wgmma`` form elsewhere;
    dynamic: ``dyn_quantize`` of the f16 rows, then the s8 kernel),
    against the plain version: dynamic bitwise, weight_only ``rtol=1e-5,
    atol=1e-5*max|y|``; then each mode's device time a shape beside the
    bound, the plain version and the library (weight_only: f16 ``addmm``
    on the dequantized panel; dynamic: ``_int_mm``), summed over a
    forward's 54 launches.  {mode: totals}."""
    gen = torch.Generator(device=device).manual_seed(1618)
    counts = {}
    for shape in shapes:
        counts[shape] = counts.get(shape, 0) + 1
    errs = {m: 0.0 for m in MODES}
    taken = {}
    for (M, K, O, bias) in counts:
        for mode in MODES:
            x, wq, scale, b = operands(M, K, O, "float16", bias, gen, device)
            xin, scale_row = prepare_operands(x, scale, mode)
            got = int8_gemm.launch(xin, wq, scale_row, b)
            v = int8_gemm.last_variant[0]
            taken[mode, v] = taken.get((mode, v), 0) + 1
            want = int8_matmul_reference(xin, wq, scale_row, b)
            torch.cuda.synchronize()
            errs[mode] = max(errs[mode], (got - want).abs().max().item())
            if mode == "dynamic" and not torch.equal(got, want):
                raise AssertionError(f"B4 dynamic on f16 rows not bitwise at "
                                     f"M={M} K={K} O={O}")
            if mode == "weight_only":
                torch.testing.assert_close(
                    got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item(),
                    msg=lambda e: f"B4 f16 M={M} K={K} O={O}: {e}")
            del x, xin, got, want
    want_taken = {("weight_only", "mma_weight_only"), ("dynamic",
                                                       "mma_dynamic"),
                  ("weight_only", "wgmma_weight_only"), ("dynamic",
                                                         "wgmma_dynamic")}
    if set(taken) != want_taken:
        raise AssertionError(f"B4 f16 rows took the variants {taken}")
    print(f"f16 gemm check: {2 * len(counts)} GEMMs on f16 rows vs "
          f"int8_matmul_reference (variants {taken}); dynamic bitwise; max "
          f"abs err weight_only {errs['weight_only']:.3e} [{card}]")
    totals = {}
    for (M, K, O, bias), n in counts.items():
        for mode in MODES:
            x, wq, scale, b = operands(M, K, O, "float16", bias, gen, device)
            xin, scale_row = prepare_operands(x, scale, mode)
            if mode == "weight_only":  # f16 addmm on the dequantized panel
                w16 = (wq.float() * scale[:, None]).T.half()
                b16 = None if b is None else b.half()
                lib = (lambda: torch.addmm(b16, x, w16)) if b is not None \
                    else (lambda: torch.mm(x, w16))
            else:
                lib = library_call(xin, wq, scale_row, b, "int8")
            k_fn = lambda: int8_gemm.launch(xin, wq, scale_row, b)  # noqa: E731
            k_ms, l_ms = gemm_device_ms(k_fn, lib)
            variant = int8_gemm.last_variant
            k_ev = cuda_ms(k_fn)
            p_ev = cuda_ms(lambda: int8_matmul_reference(xin, wq, scale_row,
                                                         b), budget_ms=10.0)
            b_ms, b_by, _ = bound(M, K, O, bias, "float16"
                                  if mode == "weight_only" else "int8")
            fmt = lambda v: "n/a" if v is None else f"{v:.4f}"  # noqa: E731
            print(f"gemm {mode:11s} f16 rows M={M:6d} K={K:4d} O={O:4d} "
                  f"bias={int(bias)} x{n} {variant[0]} tile {variant[1]}x"
                  f"{variant[2]} stages {variant[3]}: device ms kernel="
                  f"{k_ms:.4f} library={fmt(l_ms)} bound={b_ms:.4f} "
                  f"({b_by}); event-timed kernel={k_ev:.4f} "
                  f"plain={p_ev:.4f} [{card}]")
            t = totals.setdefault(mode, {
                "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "library_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                "event_ms": 0.0, "variants": {}})
            t["ms"] += n * k_ms
            t["event_ms"] += n * k_ev
            t["plain_ms"] += n * p_ev
            t["library_ms"] = None if l_ms is None or t["library_ms"] is None \
                else t["library_ms"] + n * l_ms
            t["bound_ms"] += n * b_ms
            t["bytes_ms" if b_by == "bytes" else "ops_ms"] += n * b_ms
            t["variants"][variant[0]] = t["variants"].get(variant[0], 0) + n
            del x, xin, wq, scale, scale_row, b
    for mode, t in totals.items():
        t["bound_by"] = "bytes" if t["bytes_ms"] >= t["ops_ms"] \
            else "operations"
        t["max_abs_err"] = errs[mode]
        lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        print(f"gemm {mode} f16 rows per batch-{BATCH} forward ("
              f"{len(shapes)} launches: {t['variants']}): device ms kernel="
              f"{t['ms']:.4f} library={lib} bound={t['bound_ms']:.4f} "
              f"({t['bound_by']}); event-timed kernel={t['event_ms']:.4f} "
              f"plain={t['plain_ms']:.4f} [{card}]")
    return totals


def f16_bag_phase(device, card):
    """B3 in f16 at every case of F16_BAG_CASES, forward and the
    swapped-role table gradient, bitwise against its plain version; then
    the census forward and table gradient timed: device ms a call, the
    plain version and ``F.embedding_bag`` in f16 on the pre-sorted stream,
    beside the bound.  {role: row}."""
    gen = torch.Generator(device=device).manual_seed(2024)
    for case in F16_BAG_CASES:
        name, N, V = case[:3]
        rows, cols, vals, table, g = bag_operands(case, gen, device)
        got = embed_bag.launch(rows, cols, vals, table, N)
        got_t = embed_bag.launch(cols, rows, vals, g, V)
        want = embed_bag.embedding_bag_coo_reference(rows, cols, vals, table,
                                                     N)
        want_t = embed_bag.embedding_bag_coo_reference(cols, rows, vals, g, V)
        torch.cuda.synchronize()
        if got.dtype != torch.result_type(table, vals) or not (
                torch.equal(got, want) and torch.equal(got_t, want_t)):
            raise AssertionError(f"B3 {name}: not bitwise equal to its plain "
                                 f"version ({got.dtype})")
        print(f"f16 bag check {name}: N={N} V={V} D={table.shape[1]} table "
              f"{table.dtype} values {vals.dtype} -> {got.dtype}: forward "
              f"and table gradient bitwise equal")
    rows, cols, vals, table, g = bag_operands(F16_BAG_CASES[0], gen, device)
    N, V = F16_BAG_CASES[0][1:3]
    out = {}
    for role, args, n_out in (("forward", (rows, cols, vals, table, N), N),
                              ("table_grad", (cols, rows, vals, g, V), V)):
        r, c, v, t, n = args
        k_fn = lambda: embed_bag.launch(*args)  # noqa: E731
        got = k_fn()
        k_ms = device_ms(k_fn, calls=50)
        l_ms = device_ms(library_bag(r, c, v, t, n), calls=50)
        p_ev = cuda_ms(lambda: embed_bag.embedding_bag_coo_reference(*args))
        k_ev = cuda_ms(k_fn)
        b_ms, b_by, nbytes = bag_bound(r, c, t, n_out, got.dtype)
        out[role] = {"ms": k_ms, "event_ms": k_ev, "plain_ms": p_ev,
                     "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "max_abs_err": 0.0, "out_dtype": str(got.dtype)}
        print(f"embed_bag f16 {role} N={n_out} nnz={r.numel()} table "
              f"{t.dtype} values {v.dtype}: device ms kernel={k_ms:.5f} "
              f"library={l_ms:.5f} [F.embedding_bag, pre-sorted] "
              f"bound={b_ms:.6f} ({b_by}, {nbytes} B); event-timed kernel "
              f"{k_ev:.5f} plain {p_ev:.5f} [{card}]")
    return out


def f16_kernel_phase(seed, device, card, report):
    """Every f16 form against its plain version at the shapes its paths
    give it, and timed (module docstring, 36): {kernel name: row}."""
    gen = torch.Generator(device=device).manual_seed(4321)
    errs = cell_check(CELL_SHAPES, device, card, gen, dtypes=("float16",))
    medium = (PTB["batch"], PTB["hidden"])
    rows = cell_time_rows(*medium, errs[medium], device, card, gen,
                          dtype=torch.float16)
    rows["embed_bag"] = f16_bag_phase(device, card)
    probe = quantize(resnet50().initialize(seed)).to(device)
    shapes = gemm_shapes(probe, device)
    del probe
    for mode, t in f16_gemm_phase(shapes, device, card).items():
        rows[f"int8_gemm[{mode}]"] = t
    report["f16_kernels"] = rows
    return rows


def ptb_f16_step(init, params, batch, device):
    """One PTB-medium step in f16 (``set_compute_dtype``'s mixed precision)
    on ``device`` with the LSTM cell's plain versions (on the card too),
    from ``params`` on ``batch``: the loss and the gradients clipped to
    global norm 5, as the update gets them (float64, on the CPU)."""
    m = copy.deepcopy(init).to(device)
    with torch.no_grad():
        for k, p in m.named_parameters():
            p.copy_(params[k])
            p.requires_grad_(True)
    named = dict(m.named_parameters())
    sound = lstm_cell.launch_fwd, lstm_cell.launch_bwd
    lstm_cell.launch_fwd = lstm_cell.lstm_cell_fwd_reference
    lstm_cell.launch_bwd = lstm_cell.lstm_cell_bwd_reference
    try:
        loss = mixed_precision_loss_fn(
            m, nn.TimeDistributedCriterion(nn.ClassNLLCriterion()),
            torch.float16)(named, torch.from_numpy(batch.input).to(device),
                           torch.from_numpy(batch.target).to(device))
        loss.backward()
    finally:
        lstm_cell.launch_fwd, lstm_cell.launch_bwd = sound
    grads = optim.clip_by_global_norm({k: p.grad for k, p in named.items()},
                                      5.0)
    return loss.item(), {k: g.double().cpu() for k, g in grads.items()}


def f16_ptb_phase(seed, device, card, report):
    """PTB-medium at full width trained in f16 for one K=8 block on the
    card (SGD lr 1.0, clipping at 5): B2f and B2b 35 launches a step each,
    every one f16.  Each step is redone from the card's own weights with
    the cell's plain versions on the card, everything else alike, and read
    against them (wd_step_reading, norm shares against step 0's) within
    F16["ptb_tol"], with the PTB check's two planted faults.  Returns
    {kernel: launches}."""
    K, B, T = PTB["K"], PTB["batch"], PTB["T"]
    samples = ptb_samples(seed)
    batches = [batch_samples(samples[i * B:(i + 1) * B]) for i in range(K)]
    init = ptb_model(PTB["vocab"], PTB["embed"], PTB["hidden"],
                     PTB["layers"]).initialize(seed)

    def card_run(cell=None):
        sgd = recording(optim.SGD)(learning_rate=1.0)
        losses = []

        class Recording(LocalOptimizer):
            def _log_train_iteration(self, lr):
                losses.append(self.state["loss"])

        recurrent.lstm_cell = cell or lstm_cell.lstm_cell
        try:
            (Recording(copy.deepcopy(init),
                       DataSet.array(np.zeros(K * B)) >> Prebuilt(batches, B),
                       nn.TimeDistributedCriterion(nn.ClassNLLCriterion()),
                       device=device)
             .set_optim_method(sgd).set_gradient_clipping_by_l2_norm(5.0)
             .set_compute_dtype(torch.float16).set_steps_per_dispatch(K)
             .set_end_when(optim.max_iteration(K)).optimize())
        finally:
            recurrent.lstm_cell = lstm_cell.lstm_cell
        return losses, sgd.steps

    def plain_step(init, params, batch):
        return ptb_f16_step(init, params, batch, device)

    fwd, bwd = [], []
    sound = (dtype_spy(lstm_cell, "launch_fwd", fwd),
             dtype_spy(lstm_cell, "launch_bwd", bwd))
    lstm_cell.fwd_launches = lstm_cell.bwd_launches = 0
    t0 = time.monotonic()
    try:
        losses, steps = card_run()
    finally:
        lstm_cell.launch_fwd, lstm_cell.launch_bwd = sound
    card_s = time.monotonic() - t0
    launches = {"lstm_cell_fwd": lstm_cell.fwd_launches,
                "lstm_cell_bwd": lstm_cell.bwd_launches}
    h = torch.float16
    if launches != {k: T * K for k in launches} or \
            set(fwd) != {(h,) * 4} or set(bwd) != {(torch.float32, h, h, h)}:
        raise AssertionError(f"ptb f16: launches {launches} in {K} steps, "
                             f"dtypes {set(fwd)} / {set(bwd)}")
    sound_r, worst = wd_step_reading(losses, steps, init, batches,
                                     plain_step, norm_share, True)
    faults, fault_worst = {}, {}
    for fault in ("w_t_127_128", "one_step_dz_127_128"):
        faults[fault], fault_worst[fault] = wd_step_reading(
            *card_run(planted_lstm_fault(fault, T)), init, batches,
            plain_step, norm_share, True)
    print(f"f16 ptb-medium K={K}: card block {card_s:.1f} s, losses "
          + ", ".join(f"{v:.4f}" for v in losses) + f"; B2f/B2b launches "
          f"{launches}, all f16; step by step against the plain cell on the "
          f"card (norm shares against step 0's): sound {sound_r:.3e} "
          f"{worst}, planted faults "
          + ", ".join(f"{k} {v:.3e}" for k, v in faults.items())
          + f" (tol {F16['ptb_tol']}) [{card}]")
    report["f16_ptb"] = {"losses": losses, "launches": launches,
                         "sound": sound_r, "largest": worst,
                         "planted_faults": faults,
                         "planted_largest": fault_worst,
                         "tol": F16["ptb_tol"], "card_block_s": card_s}
    if not sound_r <= F16["ptb_tol"]:
        raise AssertionError(f"f16 PTB on the card is {sound_r:.3e} from its "
                             f"plain cell, over the limit {F16['ptb_tol']}")
    for fault, err in faults.items():
        if not err > F16["ptb_tol"]:
            raise AssertionError(f"planted fault {fault} reads {err:.3e}, "
                                 f"inside the f16 PTB limit: the check is "
                                 f"blind")
    return launches


def f16_wd_phase(seed, device, card, report):
    """The census Wide&Deep trained in f16 for one K=8 block on the card:
    B3 2 calls a step, the forward on an f16 table with f16 values and the
    table gradient on the f32 cotangent with f16 values; each step read
    against the CPU in f16 from the card's own weights, with wd_check_phase's
    three planted faults.  Returns B3's launches."""
    K, B = WD["K"], WD["batch"]
    batches = wd_batches(wd_data(K * B, seed + 1))
    init = wd_model(seed)

    def cpu_step(init, params, batch):
        return wd_cpu_step(init, params, batch, torch.float16)

    def card_run(model, fault=None):
        adam = RecordingAdam(learning_rate=WD["lr"])
        sound_launch = embed_bag.launch
        if fault is not None:
            embed_bag.launch = planted_bag_fault(fault, WD_FAULT_STEP)
        try:
            losses = wd_train(model, DataSet.array(np.zeros(K * B))
                              >> Prebuilt(batches), device, K, adam,
                              torch.float16)[0]
        finally:
            embed_bag.launch = sound_launch
        return losses, adam.steps

    calls = []
    sound = dtype_spy(embed_bag, "launch", calls)
    embed_bag.launches = 0
    try:
        losses, steps = card_run(copy.deepcopy(init))
    finally:
        embed_bag.launch = sound
    launches = embed_bag.launches
    h, f = torch.float16, torch.float32
    want = [(torch.int32, torch.int32, h, h), (torch.int32, torch.int32, h, f)]
    if launches != 2 * K or calls != want * K:
        raise AssertionError(f"wide-deep f16: B3 {launches} launches in {K} "
                             f"steps, dtypes {sorted(set(calls))}")
    sound_r, worst = wd_step_reading(losses, steps, init, batches, cpu_step,
                                     norm_share, True)
    m = copy.deepcopy(init)
    with torch.no_grad():
        m.wide.weight.mul_(127 / 128)
    runs = {"wide_weight_127_128": (m, None)}
    for role in ("forward", "table_grad"):
        runs[f"b3_{role}_step{WD_FAULT_STEP}_127_128"] = (
            copy.deepcopy(init), role)
    faults, fault_worst = {}, {}
    for name, (m, role) in runs.items():
        faults[name], fault_worst[name] = wd_step_reading(
            *card_run(m, role), init, batches, cpu_step, norm_share, True)
    print(f"f16 wide-deep K={K} batch {B}: losses "
          + ", ".join(f"{v:.6f}" for v in losses) + f"; B3 {launches} calls, "
          f"forward f16 table and values, table gradient f32 cotangent and "
          f"f16 values; card-vs-cpu step by step (norm shares against step "
          f"0's): sound {sound_r:.3e} {worst}, planted faults "
          + ", ".join(f"{k} {v:.3e}" for k, v in faults.items())
          + f" (tol {F16['wd_tol']}) [{card}]")
    report["f16_wide_deep"] = {"losses": losses, "launches": launches,
                               "sound": sound_r, "largest": worst,
                               "planted_faults": faults,
                               "planted_largest": fault_worst,
                               "tol": F16["wd_tol"]}
    if not sound_r <= F16["wd_tol"]:
        raise AssertionError(f"f16 Wide&Deep on the card is {sound_r:.3e} "
                             f"from the CPU, over the limit {F16['wd_tol']}")
    for fault, err in faults.items():
        if not err > F16["wd_tol"]:
            raise AssertionError(f"planted fault {fault} reads {err:.3e}, "
                                 f"inside the f16 Wide&Deep limit: the check "
                                 f"is blind")
    return launches


def f16_serving_phase(mode, seed, device, card, report):
    """The int8 ResNet-50 deployed with an f16 input spec and served four
    lone requests of 1-4 f16 rows: 54 B4 launches a dispatch, 1 mma (the
    stem, on f16 rows: weight_only's f16 form, or dynamic's s8 kernel after
    ``dyn_quantize`` in f16) and 53 ``wgmma`` on the stem's f32 outputs, as
    the reference computes them; each output within SERVE_TOL of the same
    model on the CPU, with the serving phase's planted faults.  Returns
    (launches, f16 launches)."""
    model = resnet50().initialize(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed + 16)
    samples = [rng.normal(0, 1, (int(rng.integers(1, 5)),) + SPEC[0]).astype(
        np.float16) for _ in range(4)]
    with ModelRegistry(device=device) as reg:
        svc = reg.deploy("resnet50", model, input_spec=(SPEC[0], np.float16),
                         max_batch_size=BATCH,
                         quantize=True if mode == "weight_only" else mode)
        quantized = [m for m in svc.model.modules() if isinstance(
            m, (QuantizedSpatialConvolution, QuantizedLinear))]
        rows = []
        hooks = [m.register_forward_pre_hook(
            lambda m, args: rows.append(args[0].dtype)) for m in quantized]
        calls = []
        sound = dtype_spy(int8_gemm, "launch", calls)
        int8_gemm.reset_counts()
        before = svc.stats()["dispatch_count"]
        try:
            served = [reg.predict("resnet50", x, timeout=300)
                      for x in samples]
        finally:
            int8_gemm.launch = sound
            for hk in hooks:
                hk.remove()
        dispatches = svc.stats()["dispatch_count"] - before
        launches = int8_gemm.launches
        variants = {v: n for v, n in int8_gemm.variant_launches.items() if n}
    f16_rows = rows.count(torch.float16)
    f16_launches = sum(c[0] == torch.float16 for c in calls)
    want = {f"mma_{mode}": dispatches, f"wgmma_{mode}": 53 * dispatches}
    if launches != 54 * dispatches or variants != want or \
            f16_rows != dispatches or rows.count(torch.float32) != \
            53 * dispatches or f16_launches != (
                dispatches if mode == "weight_only" else 0):
        raise AssertionError(f"f16 serving {mode}: {launches} launches for "
                             f"{dispatches} dispatches ({variants}), "
                             f"{f16_rows} f16 inputs to quantized layers, "
                             f"{f16_launches} f16 launches")
    cpu_model = quantize(model, mode=mode)
    with torch.inference_mode():
        wants = [cpu_model(torch.from_numpy(x)).numpy() for x in samples]
    worst = max(rel_err(y, w) for y, w in zip(served, wants))
    faults = planted_fault_errors(model, mode, samples, wants, device)
    print(f"f16 serving {mode}: {dispatches} dispatches of f16 rows, B4 "
          f"{launches} launches ({variants}), the stem on f16 rows "
          f"({f16_launches} f16 launches), {rows.count(torch.float32)} f32 "
          f"inputs; served-vs-cpu sound {worst:.3e}, planted faults "
          + ", ".join(f"{k} {v:.3e}" for k, v in faults.items())
          + f" (tol {SERVE_TOL[mode]}) [{card}]")
    report.setdefault("f16_serving", {})[mode] = {
        "dispatches": dispatches, "launches": launches,
        "variant_launches": variants, "f16_launches": f16_launches,
        "cpu_rel_err": worst, "planted_fault_rel_err": faults}
    if not worst <= SERVE_TOL[mode]:
        raise AssertionError(f"f16 serving {mode}: {worst:.3e} from the CPU")
    for fault, err in faults.items():
        if not err > SERVE_TOL[mode]:
            raise AssertionError(f"f16 serving {mode}: planted fault {fault} "
                                 f"reads {err:.3e}: the check is blind")
    return launches, f16_launches


def f16_paths_phase(seed, device, card, report):
    """The f16 paths (module docstring, 36): {kernel: f16 launches}."""
    out = {}
    for label, run in (("ptb", f16_ptb_phase), ("wide-deep", f16_wd_phase)):
        t0 = time.monotonic()
        out[label] = run(seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase f16-{label}: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    out["serving"] = {m: f16_serving_phase(m, seed, device, card, report)
                      for m in MODES}
    torch.cuda.empty_cache()
    print(f"phase f16-serving: {time.monotonic() - t0:.1f} s")
    return {"lstm_cell_fwd": out["ptb"]["lstm_cell_fwd"],
            "lstm_cell_bwd": out["ptb"]["lstm_cell_bwd"],
            "embed_bag": out["wide-deep"],
            "int8_gemm[weight_only]": out["serving"]["weight_only"],
            "int8_gemm[dynamic]": out["serving"]["dynamic"]}


PHASES = ("resnet", "lstm", "resnet-train", "seqfile", "wide-deep", "lenet",
          "distri", "cifar", "inception", "autoencoder", "remat", "text",
          "nn-core", "resilience", "interop", "predict", "keras",
          "frontend", "parallel", "quantized-rnn", "seq-pipe", "tail", "f16")


def add_f16_rows(kernels, rows, launches):
    """Each f16 form's row under its kernel's entry of the kernels line,
    with its launches on the f16 paths; a kernel that no earlier path ran
    gets an entry led by its f16 row."""
    by_name = {k["name"]: k for k in kernels}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    meta = {**{k: v for k, v in LSTM_KERNELS.items()}, "embed_bag": BAG_KERNEL,
            "int8_gemm[weight_only]": KERNEL, "int8_gemm[dynamic]": KERNEL}
    for name, n in launches.items():
        row = rows[name]["forward"] if name == "embed_bag" else rows[name]
        if name.startswith("int8_gemm"):  # (launches, launches on f16 x)
            f16 = {"launches": n[0], "f16_x_launches": n[1]}
        else:
            f16 = {"launches": n}
        f16.update({k: row[k] for k in keys})
        if name == "embed_bag":
            f16["table_grad"] = {k: rows[name]["table_grad"][k]
                                 for k in keys}
        entry = by_name.get(name)
        if entry is None:  # no earlier path ran it: the f16 path leads
            entry = {"name": name, **meta[name], "launches": f16["launches"],
                     **{k: row[k] for k in keys}}
            kernels.append(entry)
        entry["f16"] = f16
EXTRA_PHASES = ("resnet-conditioning",)  # run only when named


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", default=None,
                    help="also write the full report to this JSON file")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                         + ",".join(PHASES + EXTRA_PHASES) + " (default: "
                         + ",".join(PHASES) + "; the kernels line lists the "
                           "phases run)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if not phases <= set(PHASES + EXTRA_PHASES):
        ap.error(f"unknown phases "
                 f"{sorted(phases - set(PHASES + EXTRA_PHASES))}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); the port's smoke test runs only on the card",
              file=sys.stderr)
        return 2
    device = torch.device("cuda")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = card_line()
    print(f"device: {name} x{count}; nvidia-smi: {card}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.monotonic()
    for lib in _build.SOURCES:  # the first load builds every library
        _build.load(lib)
    print(f"build: {time.monotonic() - t0:.1f} s (nvcc, one process a "
          f"source, {_build.build_seconds:.1f} s)")
    for lib, text in _build.ptxas_report.items():
        for line in text.splitlines():
            print(f"ptxas[{lib}]: {line.strip()}")
    print(f"phase build: {time.monotonic() - t0:.1f} s")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    report = {"card": card, "device": name, "shapes": [], "serving": {},
              "profile": {}}
    kernels = []
    if "resnet" in phases:
        t0 = time.monotonic()
        probe = quantize(resnet50().initialize(args.seed)).to(device)
        shapes = gemm_shapes(probe, device)
        del probe
        if len(shapes) != 54:
            raise AssertionError(f"ResNet-50 forward ran {len(shapes)} GEMMs")
        print(f"resnet50 batch {BATCH}: {len(shapes)} GEMM launches per "
              f"forward, {len(set(shapes))} distinct shapes")
        totals = kernel_phase(shapes, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase int8-kernels: {time.monotonic() - t0:.1f} s")

        t0 = time.monotonic()
        for mode in ("weight_only", "dynamic"):
            profile_phase(mode, args.seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase int8-profile: {time.monotonic() - t0:.1f} s")

        t0 = time.monotonic()
        launches = {m: serving_phase(m, args.seed, device, card, report)
                    for m in ("weight_only", "dynamic")}
        torch.cuda.empty_cache()
        print(f"phase serving: {time.monotonic() - t0:.1f} s")
        for mode in ("weight_only", "dynamic"):
            t = totals[mode]
            kernels.append({
                "name": f"int8_gemm[{mode}]", **KERNEL,
                "launches": launches[mode], "max_abs_err": t["max_abs_err"],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"]
                else "operations",
                **({"bound_cuda_cores_ms": t["bound_cuda_cores_ms"]}
                   if mode == "weight_only" else {}),
                "library_ms": t["library_ms"],
                "variant_launches": report["serving"][mode][
                    "variant_launches"],
                "event_ms": t["event_ms"],
                "library_event_ms": t["library_event_ms"]})

    nhwc_totals = None
    if "parallel" in phases:
        # B4 at the NHWC int8 path's GEMMs while the process is young
        t0 = time.monotonic()
        nhwc_totals = nhwc_kernel_phase(args.seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase int8-kernels-nhwc: {time.monotonic() - t0:.1f} s")
    qrnn_totals = None
    if "quantized-rnn" in phases:
        # B4 at the quantized cells' GEMMs while the process is young
        t0 = time.monotonic()
        qrnn_totals = qrnn_kernel_phase(args.seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase int8-kernels-qrnn: {time.monotonic() - t0:.1f} s")

    if "lstm" in phases:
        t0 = time.monotonic()
        rows, small_rows = lstm_kernel_phase(device, card, report)
        print(f"phase lstm-kernels: {time.monotonic() - t0:.1f} s")
        launches = training_phase(args.seed, device, card, report)
        torch.cuda.empty_cache()
        for kernel, row in rows.items():
            kernels.append({"name": kernel, **LSTM_KERNELS[kernel],
                            "launches": launches[kernel], **row})

    if "resnet-train" in phases:
        t0 = time.monotonic()
        row = pool_kernel_phase(device, card, report)
        torch.cuda.empty_cache()
        print(f"phase pool-kernel: {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        launches = resnet_timed_phase(args.seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase resnet-train-timed: {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        resnet_check_phase(args.seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase resnet-train-vs-cpu: {time.monotonic() - t0:.1f} s")
        kernels.append({"name": "maxpool_bwd", **POOL_KERNEL,
                        "launches": launches,
                        **{k: row[k] for k in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms", "variant")},
                        "f32": {k: report["pool_kernel"]["stem_nhwc_f32"][k]
                                for k in ("ms", "plain_ms", "bound_ms",
                                          "library_ms")}})
    if "seqfile" in phases:
        t0 = time.monotonic()
        launches = seqfile_phase(args.seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase seqfile: {time.monotonic() - t0:.1f} s")
        entry = next((k for k in kernels if k["name"] == "maxpool_bwd"),
                     None)
        if entry is None:  # the stem was not timed: check and time it
            gen = torch.Generator(device=device).manual_seed(2718)
            row = pool_row(pool_case("stem_nhwc_bf16"), gen, device, card)
            entry = {"name": "maxpool_bwd", **POOL_KERNEL,
                     "launches": launches,
                     **{k: row[k] for k in (
                         "max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms", "variant")}}
            kernels.append(entry)
        entry["seqfile"] = {"launches": launches}
    f16_rows = None
    if "tail" in phases:
        # B1 in f16, checked and timed while the process is young
        t0 = time.monotonic()
        f16_rows = f16_pool_phase(device, card, report)
        torch.cuda.empty_cache()
        print(f"phase f16-pool: {time.monotonic() - t0:.1f} s")
    f16_kernel_rows = None
    if "f16" in phases:
        # B2f, B2b, B3 and B4 in f16, checked and timed while the process
        # is young
        t0 = time.monotonic()
        f16_kernel_rows = f16_kernel_phase(args.seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase f16-kernels: {time.monotonic() - t0:.1f} s")
    if "wide-deep" in phases:
        t0 = time.monotonic()
        row = bag_kernel_phase(device, card, report)
        torch.cuda.empty_cache()
        print(f"phase bag-kernel: {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        launches = wd_timed_phase(args.seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase wide-deep-timed: {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        wd_check_phase(args.seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase wide-deep-vs-cpu: {time.monotonic() - t0:.1f} s")
        kernels.append({"name": "embed_bag", **BAG_KERNEL,
                        "launches": launches,
                        **{k: row[k] for k in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms")},
                        "split": row["split"],
                        "library_route_ms": row["library_route_ms"],
                        "table_grad": {k: report["bag_kernel"]["table_grad"][k]
                                       for k in ("ms", "split", "plain_ms",
                                                 "bound_ms", "library_ms",
                                                 "library_route_ms")}})
    if "lenet" in phases:
        t0 = time.monotonic()
        rows = lenet_pool_phase(device, card, report)
        torch.cuda.empty_cache()
        print(f"phase lenet-pool: {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        launches = lenet_timed_phase(args.seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase lenet-timed: {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        lenet_check_phase(args.seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase lenet-vs-cpu: {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        lenet_resume_phase(device, card, report)
        torch.cuda.empty_cache()
        print(f"phase lenet-resume: {time.monotonic() - t0:.1f} s")
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "variant")
        lenet_row = {"launches": launches,
                     **{name: {k: row[k] for k in keys}
                        for name, row in rows.items()}}
        entry = next((k for k in kernels if k["name"] == "maxpool_bwd"),
                     None)
        if entry is None:  # the stem was not run: LeNet's first pool leads
            entry = {"name": "maxpool_bwd", **POOL_KERNEL,
                     "launches": launches,
                     **{k: rows[LENET_POOL_CASES[0]][k] for k in keys}}
            kernels.append(entry)
        entry["lenet"] = lenet_row
    if "distri" in phases:
        launches = distri_phase(args.seed, device, card, report)
        entry = next((k for k in kernels if k["name"] == "maxpool_bwd"),
                     None)
        if entry is None:  # the stem was not checked: check and time it
            gen = torch.Generator(device=device).manual_seed(2718)
            row = pool_row(pool_case("stem_nhwc_bf16"), gen, device, card)
            entry = {"name": "maxpool_bwd", **POOL_KERNEL,
                     "launches": launches,
                     **{k: row[k] for k in (
                         "max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms", "variant")}}
            kernels.append(entry)
        entry["distri"] = {"launches": launches}
    pool_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "variant")
    # B1 at both paths' pools, bitwise and timed; then their training runs
    pool_rows = {}
    for phase, names, pool_seed in (("cifar", VGG_POOL_CASES, 1618),
                                    ("inception", INCEPTION_POOL_CASES, 1414)):
        if phase in phases:
            t0 = time.monotonic()
            pool_rows[phase] = pool_cases_phase(names, pool_seed, device, card,
                                                report, f"{phase}_pool")
            print(f"phase {phase}-pool: {time.monotonic() - t0:.1f} s")
    for phase, run in (("cifar", cifar_phase), ("inception", inception_phase)):
        if phase not in phases:
            continue
        runs, rows = run(args.seed, device, card, report), pool_rows[phase]
        launches = runs["vgg"]["launches"] if phase == "cifar" else runs
        entry = next((k for k in kernels if k["name"] == "maxpool_bwd"),
                     None)
        if entry is None:  # no earlier path ran B1: this one leads
            first = next(iter(rows.values()))
            entry = {"name": "maxpool_bwd", **POOL_KERNEL,
                     "launches": launches,
                     **{k: first[k] for k in pool_keys}}
            kernels.append(entry)
        entry[phase] = {"launches": launches,
                        **{name: {k: row[k] for k in pool_keys}
                           for name, row in rows.items()}}
        if phase == "cifar":
            entry[phase]["vgg_distri_launches"] = \
                runs["vgg_distri"]["launches"]
            entry[phase]["resnet20_launches"] = runs["resnet20"]["launches"]
        else:
            entry[phase]["check_launches"] = \
                report["inception_check"]["launches"]
    if "autoencoder" in phases:
        t0 = time.monotonic()
        autoencoder_phase(args.seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase autoencoder: {time.monotonic() - t0:.1f} s")
    if "remat" in phases:
        t0 = time.monotonic()
        launches = remat_phase(args.seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase remat: {time.monotonic() - t0:.1f} s")
        entry = next((k for k in kernels if k["name"] == "maxpool_bwd"),
                     None)
        if entry is None:  # no earlier path ran B1: check and time the stem
            gen = torch.Generator(device=device).manual_seed(2718)
            row = pool_row(pool_case("stem_nhwc_bf16"), gen, device, card)
            entry = {"name": "maxpool_bwd", **POOL_KERNEL,
                     "launches": sum(launches.values()),
                     **{k: row[k] for k in pool_keys}}
            kernels.append(entry)
        entry["remat"] = {"launches": launches,
                          "check_launches": {
                              m: r["launches"] for m, r in
                              report["remat_check"].items()}}
    if "text" in phases:
        gen = torch.Generator(device=device).manual_seed(4321)
        entries = {k["name"]: k for k in kernels if k["name"] in LSTM_KERNELS}
        if not entries:  # the lstm phase did not run: check and time B2f/B2b
            t0 = time.monotonic()
            small = (PTB_SMALL["batch"], PTB_SMALL["hidden"])
            errs = cell_check([small], device, card, gen)
            small_rows = cell_time_rows(*small, errs[small], device, card,
                                        gen)
            print(f"phase lstm-kernels-ptb-small: "
                  f"{time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        launches = text_phase(args.seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase text: {time.monotonic() - t0:.1f} s")
        for kernel, row in small_rows.items():
            if kernel not in entries:  # the text path leads
                entries[kernel] = {"name": kernel, **LSTM_KERNELS[kernel],
                                   "launches": launches[kernel], **row}
                kernels.append(entries[kernel])
            entries[kernel]["text"] = {"launches": launches[kernel], **row}
    if "nn-core" in phases:
        t0 = time.monotonic()
        nn_core_phase(args.seed, device, card, report)
        print(f"phase nn-core: {time.monotonic() - t0:.1f} s")
    if "resilience" in phases:
        t0 = time.monotonic()
        launches, shapes = resilience_phase(args.seed, device, card, report)
        print(f"phase resilience: {time.monotonic() - t0:.1f} s")
        by_name = {k["name"]: k for k in kernels}
        gen = torch.Generator(device=device).manual_seed(4321)
        if not all(k in by_name for k in LSTM_KERNELS):
            # no earlier phase timed B2f/B2b: check and time PTB-medium's
            t0 = time.monotonic()
            shape = (PTB["batch"], PTB["hidden"])
            errs = cell_check([shape], device, card, gen)
            for kernel, row in cell_time_rows(*shape, errs[shape], device,
                                              card, gen).items():
                by_name[kernel] = {"name": kernel, **LSTM_KERNELS[kernel],
                                   "launches": launches["ptb"][kernel],
                                   **row}
                kernels.append(by_name[kernel])
            print(f"phase lstm-kernels-resilience: "
                  f"{time.monotonic() - t0:.1f} s")
        if "maxpool_bwd" not in by_name:
            # no earlier phase timed B1: LeNet's first pool leads
            row = pool_row(pool_case(LENET_POOL_CASES[0]), gen, device, card)
            by_name["maxpool_bwd"] = {
                "name": "maxpool_bwd", **POOL_KERNEL,
                "launches": launches["lenet"],
                **{k: row[k] for k in pool_keys}}
            kernels.append(by_name["maxpool_bwd"])
        if "int8_gemm[weight_only]" not in by_name:
            # no earlier phase timed B4: time the served forward's GEMMs
            t0 = time.monotonic()
            t = kernel_phase(shapes, device, card, report)["weight_only"]
            by_name["int8_gemm[weight_only]"] = {
                "name": "int8_gemm[weight_only]", **KERNEL,
                "launches": launches["int8_gemm"],
                **{k: t[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "library_ms")},
                "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"]
                else "operations",
                "rows_a_forward": RESIL["serve_rows"]}
            kernels.append(by_name["int8_gemm[weight_only]"])
            print(f"phase int8-kernels-resilience: "
                  f"{time.monotonic() - t0:.1f} s")
        for kernel in LSTM_KERNELS:
            by_name[kernel]["resilience"] = {
                "launches": launches["ptb"][kernel]}
        by_name["maxpool_bwd"]["resilience"] = {"launches": launches["lenet"]}
        by_name["int8_gemm[weight_only]"]["resilience"] = {
            "launches": launches["int8_gemm"]}
    if "interop" in phases:
        t0 = time.monotonic()
        launches = interop_phase(args.seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase interop: {time.monotonic() - t0:.1f} s")
        by_name = {k["name"]: k for k in kernels}
        missing = [m for m in ("weight_only", "dynamic")
                   if f"int8_gemm[{m}]" not in by_name]
        if missing:
            # no earlier phase timed B4: time the served forward's GEMMs
            t0 = time.monotonic()
            probe = quantize(resnet50().initialize(args.seed)).to(device)
            shapes = gemm_shapes(probe, device)
            del probe
            totals = kernel_phase(shapes, device, card, report)
            for mode in missing:
                t = totals[mode]
                by_name[f"int8_gemm[{mode}]"] = {
                    "name": f"int8_gemm[{mode}]", **KERNEL,
                    "launches": sum(launches[mode].values()),
                    **{k: t[k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "library_ms")},
                    "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"]
                    else "operations"}
                kernels.append(by_name[f"int8_gemm[{mode}]"])
            print(f"phase int8-kernels-interop: "
                  f"{time.monotonic() - t0:.1f} s")
        for mode in ("weight_only", "dynamic"):
            by_name[f"int8_gemm[{mode}]"]["interop"] = {
                "launches": sum(launches[mode].values()), **launches[mode]}
    if "predict" in phases:
        t0 = time.monotonic()
        launches = predict_phase(args.seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase predict: {time.monotonic() - t0:.1f} s")
        by_name = {k["name"]: k for k in kernels}
        missing = [m for m in ("weight_only", "dynamic")
                   if f"int8_gemm[{m}]" not in by_name]
        if missing:
            # no earlier phase timed B4: time the served forward's GEMMs
            t0 = time.monotonic()
            probe = quantize(resnet50().initialize(args.seed)).to(device)
            shapes = gemm_shapes(probe, device)
            del probe
            totals = kernel_phase(shapes, device, card, report)
            for mode in missing:
                t = totals[mode]
                by_name[f"int8_gemm[{mode}]"] = {
                    "name": f"int8_gemm[{mode}]", **KERNEL,
                    "launches": launches["int8_gemm"][mode],
                    **{k: t[k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "library_ms")},
                    "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"]
                    else "operations"}
                kernels.append(by_name[f"int8_gemm[{mode}]"])
            print(f"phase int8-kernels-predict: "
                  f"{time.monotonic() - t0:.1f} s")
        if "maxpool_bwd" not in by_name:
            # no earlier phase timed B1: LeNet's first pool leads
            gen = torch.Generator(device=device).manual_seed(2718)
            row = pool_row(pool_case(LENET_POOL_CASES[0]), gen, device, card)
            by_name["maxpool_bwd"] = {
                "name": "maxpool_bwd", **POOL_KERNEL,
                "launches": launches["maxpool_bwd"],
                **{k: row[k] for k in pool_keys}}
            kernels.append(by_name["maxpool_bwd"])
        for mode in ("weight_only", "dynamic"):
            by_name[f"int8_gemm[{mode}]"]["predict"] = {
                "launches": launches["int8_gemm"][mode]}
        by_name["maxpool_bwd"]["predict"] = {
            "launches": launches["maxpool_bwd"]}
    if "keras" in phases:
        t0 = time.monotonic()
        launches = keras_phase(args.seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase keras: {time.monotonic() - t0:.1f} s")
        # B2f/B2b at the text classifier's (128, 128): checked and timed
        t0 = time.monotonic()
        gen = torch.Generator(device=device).manual_seed(4321)
        shape = (KERAS["batch"], KERAS["hidden"])
        errs = cell_check([shape], device, card, gen)
        rows = cell_time_rows(*shape, errs[shape], device, card, gen)
        print(f"phase lstm-kernels-keras: {time.monotonic() - t0:.1f} s")
        by_name = {k["name"]: k for k in kernels}
        for kernel, row in rows.items():
            if kernel not in by_name:  # the Keras text path leads
                by_name[kernel] = {"name": kernel, **LSTM_KERNELS[kernel],
                                   "launches": launches[kernel], **row}
                kernels.append(by_name[kernel])
            by_name[kernel]["keras"] = {"launches": launches[kernel], **row}
        if "maxpool_bwd" not in by_name:
            # no earlier phase timed B1: LeNet's first pool leads
            row = pool_row(pool_case(LENET_POOL_CASES[0]), gen, device, card)
            by_name["maxpool_bwd"] = {
                "name": "maxpool_bwd", **POOL_KERNEL,
                "launches": launches["maxpool_bwd"],
                **{k: row[k] for k in pool_keys}}
            kernels.append(by_name["maxpool_bwd"])
        by_name["maxpool_bwd"]["keras"] = {
            "launches": launches["maxpool_bwd"]}
    if "frontend" in phases:
        t0 = time.monotonic()
        launches = frontend_phase(args.seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase frontend: {time.monotonic() - t0:.1f} s")
        by_name = {k["name"]: k for k in kernels}
        missing = [m for m in ("weight_only", "dynamic")
                   if f"int8_gemm[{m}]" not in by_name]
        if missing:
            # no earlier phase timed B4: time the served forward's GEMMs
            t0 = time.monotonic()
            probe = quantize(resnet50().initialize(args.seed)).to(device)
            shapes = gemm_shapes(probe, device)
            del probe
            totals = kernel_phase(shapes, device, card, report)
            for mode in missing:
                t = totals[mode]
                by_name[f"int8_gemm[{mode}]"] = {
                    "name": f"int8_gemm[{mode}]", **KERNEL,
                    "launches": launches[mode],
                    **{k: t[k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "library_ms")},
                    "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"]
                    else "operations"}
                kernels.append(by_name[f"int8_gemm[{mode}]"])
            print(f"phase int8-kernels-frontend: "
                  f"{time.monotonic() - t0:.1f} s")
        for mode in ("weight_only", "dynamic"):
            by_name[f"int8_gemm[{mode}]"]["frontend"] = {
                "launches": launches[mode]}
    if "parallel" in phases:
        t0 = time.monotonic()
        launches = parallel_phase(args.seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase parallel: {time.monotonic() - t0:.1f} s")
        by_name = {k["name"]: k for k in kernels}
        for mode in ("weight_only", "dynamic"):
            t = nhwc_totals[mode]
            row = {**{k: t[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "library_ms")},
                   "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"]
                   else "operations"}
            entry = by_name.get(f"int8_gemm[{mode}]")
            if entry is None:  # no earlier phase timed B4: NHWC leads
                entry = {"name": f"int8_gemm[{mode}]", **KERNEL,
                         "launches": launches[mode], **row}
                kernels.append(entry)
            entry["parallel"] = {"launches": launches[mode],
                                 "nhwc": {**row, "rows_a_forward":
                                          PARALLEL["int8_batch"]}}
    if "quantized-rnn" in phases:
        t0 = time.monotonic()
        launches, variants = qrnn_phase(args.seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase quantized-rnn: {time.monotonic() - t0:.1f} s")
        by_name = {k["name"]: k for k in kernels}
        for mode in ("weight_only", "dynamic"):
            rows = {}
            for cell, totals in qrnn_totals.items():
                t = totals[mode]
                rows[cell] = {
                    **{k: t[k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "library_ms",
                                         "int_mm_ms", "variants")},
                    "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"]
                    else "operations", "rows_a_forward": QRNN["rows"]}
            entry = by_name.get(f"int8_gemm[{mode}]")
            if entry is None:  # no earlier phase timed B4: the LSTM leads
                entry = {"name": f"int8_gemm[{mode}]", **KERNEL,
                         "launches": launches[mode],
                         **{k: v for k, v in rows["lstm"].items()
                            if k not in ("variants", "rows_a_forward",
                                         "int_mm_ms")}}
                kernels.append(entry)
            entry["quantized_rnn"] = {"launches": launches[mode],
                                      "variant_launches": variants[mode],
                                      **rows}
    if "seq-pipe" in phases:
        t0 = time.monotonic()
        seq_pipe_phase(args.seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase seq-pipe: {time.monotonic() - t0:.1f} s")
    if "tail" in phases:
        t0 = time.monotonic()
        launches = tail_phase(args.seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase tail: {time.monotonic() - t0:.1f} s")
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "variant")
        entry = next((k for k in kernels if k["name"] == "maxpool_bwd"),
                     None)
        if entry is None:  # no earlier path ran B1: the f16 stem leads
            entry = {"name": "maxpool_bwd", **POOL_KERNEL,
                     "launches": launches,
                     **{k: f16_rows["stem_nhwc_f16"][k] for k in keys}}
            kernels.append(entry)
        entry["f16"] = {"launches": launches, "cases": list(F16_POOL_CASES),
                        **{name: {k: row[k] for k in keys}
                           for name, row in f16_rows.items()}}
    if "f16" in phases:
        t0 = time.monotonic()
        launches = f16_paths_phase(args.seed, device, card, report)
        print(f"phase f16: {time.monotonic() - t0:.1f} s")
        add_f16_rows(kernels, f16_kernel_rows, launches)
    if "resnet-conditioning" in phases:
        t0 = time.monotonic()
        resnet_conditioning_phase(args.seed, device, card, report)
        print(f"phase resnet-conditioning: {time.monotonic() - t0:.1f} s")
    report["kernels"] = kernels
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1, default=str)
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
