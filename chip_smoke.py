"""Chip smoke test of the PyTorch/CUDA port (``oim_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py              # the whole check, one card
    python3 chip_smoke.py --profile    # also torch.profiler breakdowns of
                                       # one llama training step, one decode
                                       # step, one ResNet step and one MoE
                                       # step into chiprun_out/

Phases, in order; any failure exits nonzero:

1. card: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, TF32 off for every float32 product.
2. build: the three flash-attention kernels compiled from
   ``oim_tpu_torch/kernels/csrc`` (one nvcc per source, all at once), with
   ptxas's register and spill lines printed; then the C++ read engine
   compiled by g++ from ``native/staging.cc`` into
   ``oim_tpu_torch/data/build/`` and loaded (g++'s version and whether
   libjpeg was found printed). A failed build fails the run.
3. kernels: each kernel (K1 forward, K2 dK/dV, K3 dQ) held against its
   plain PyTorch version on the same inputs, at the attention call of
   each path the script drives, each bf16 at head_dim 128 and required to
   take the wgmma route: llama3-8b's, GQA group 4, for phases 5, 8 and 9;
   the MoE flagship's, group 2, for phase 11; phase 15's blocks at 2048
   positions a rank with the lse cotangent in delta (the causal diagonal,
   a ring's full block, zigzag's 2048 x 1024 and 1024 x 2048 rectangles),
   Ulysses' 16 heads over all 4096 positions, and one rank's 4096;
   tensor parallelism's heads a rank over 4096 positions (16/4 at
   model=2, phase 15's, and 8/2 at model=4); the MoE flagship's row a
   rank under phase 15's fsdp=2 (q [1,2048,16,128]; in float32, as (b)
   runs it, among the odd cases on the fma route); and
   on small odd shapes (non-causal, GQA groups 1 and 4, tq < tk, tq > tk
   with fully masked rows, lengths not a multiple of the tile, a delta that
   carries an lse cotangent, a bf16 head_dim that the kernels serve by the
   fma route); each K1 launch must take the route ``kernels.fwd_route``
   names, each K2/K3 launch the one ``kernels.bwd_route`` names. Its time
   (at llama3-8b's shape) beside its plain version's, its bound, and scaled_dot_product_attention
   with an explicit bottom-right mask as a yardstick the port never calls;
   each kernel also timed on its fma route (the first port's kernels) on
   the same inputs, and each route's registers, spills, shared memory and
   blocks per SM printed.
4. agreement: llama.tiny's loss and gradients on the card (kernels) held
   against the same model on the CPU (plain versions).
5. main path: the CLI's Trainer on llama3-8b at full width, cut to
   LAYERS layers, B=BATCH, T=SEQ, for STEPS steps, with ``--trace-dir``
   a temporary directory. Every loss finite, the first near ln(vocab),
   each kernel's launch count equal to n_layers x steps, every K1, K2
   and K3 launch on the wgmma route, the ``oim_train_step_seconds``,
   ``oim_train_mfu`` and ``oim_feed_wait_seconds`` gauges equal to the
   last logged step's values, and the span file one ``train.step`` span
   for each step.
6. serving agreement (llama.tiny, f32, TF32 off): ``prefill_into_pages``,
   ``decode_step`` and ``verify_step`` logits on the card held against the
   CPU; the engine's greedy streams on the card equal to solo
   ``generate()`` on the card; a self-draft speculating engine's greedy
   streams equal to the plain engine's; a host-tier demote -> promote
   round trip of a bf16 page exact to the bit; the plain and the
   speculating engine at shard 2 (``devices=["cuda:0", "cuda:0"]``, two
   members sharing the card) with greedy streams equal to shard 1's.
7. serving main path: ``ServeEngine`` on llama3-8b at full width and full
   depth (32 layers, bf16, weights from ``llama.init`` on the card), 12
   requests from a seeded numpy generator (prompts of 17..1500 tokens,
   four sharing a 512-token prefix, half greedy and half sampled, one
   cancelled after 8 tokens). It fails unless every request ends as it
   must, the prefix store serves 3 hits (3 x 512 tokens), a request
   promoted back from the host tier repeats its first stream, and the
   pool is empty after drain and eviction, and an 8-row paged batch's
   first-decode logits lie within SERVE_LOGIT_REL x max|logit| of solo
   ``cached_forward``; then a self-draft speculating engine must accept
   tokens (> 1 token per target step). It prints the first token of one
   request on an idle engine (miss and host-tier hit), the burst's
   first-token and inter-token percentiles as smoke readings (12
   requests are not a load), the 8-row decode step's time beside its
   bound, solo prefill times by bucket, peak memory, greedy agreement
   with solo ``generate()`` (reported, not required), and the ``serve``
   JSON line.
   Its observability, read back: spans stream to a file in a temporary
   directory and a ``MetricsServer`` listens on 127.0.0.1 (port 0). One
   scrape of ``/metrics`` over HTTP after the burst must count each
   outcome as the handles ended (the cancelled one included), every
   token the handles received, one first-token latency for each request
   that emitted one, 3 prefix hits and 3 x 512 prompt tokens from the
   store; the histogram's inter-token p50 and p99 buckets must lie within
   one bucket of the host clock's percentiles. The host-tier counters
   must equal ``host_stats()``, the pages-used gauge read 0 after drain
   and eviction, and the span file hold one ``serve.queue_wait``, one
   ``serve.prefill`` and one ``serve.decode`` span for each request.
   Then ``serve.decode`` is armed on a llama.tiny engine on the card:
   every request must end "error" and a later submit be refused.
   ``--profile`` adds a torch.profiler breakdown of one 8-row decode step
   (``chiprun_out/chip_smoke_serve_profile.json``).
   Then tensor-parallel serving (``phase_serve_sharded``), the same
   weights: a member-memory budget of exactly what a member needs at
   shard 2 must refuse the model at shard 1 and admit it at shard 2;
   ``ServeEngine(shard=2, devices=["cuda:0", "cuda:0"])`` (two members
   sharing the card, the member group of ``serve/shard.py``) must hold
   ``member_weight_bytes`` a member, replay the 12 requests in phase 7's
   order and observe one allreduce per target dispatch; each greedy
   stream of phase 7 (shard 1), fed through the engine's own paged target
   forwards (the prompt's prefill, one decode step, a verify of the
   rest) on one device and on the two members with their KV-head slices
   of the page pool, must give logits within SERVE_LOGIT_REL x
   max|logit| of one device's at every generated position. How far the replayed streams equal phase 7's is reported,
   not required: at bf16 the sharded products sum in other orders than
   the whole ones and round differently in places, and this random
   model's greedy streams turn on such differences within tens of tokens, as
   phase 7's own streams do against solo ``generate()`` and against
   speculation (phase 6 requires the byte identity in f32). It prints
   the 8-row decode step at shard 1 and at shard 2 (a reading, not a
   claim: both members share one card) and one 1 KiB allreduce.
8. OIM-fed training: a 4 GiB int32 token volume (FED_TOKENS tokens from a
   seeded generator) written as .npy to a temporary directory and staged
   through ``CUDABackend`` (64 MiB chunks, an 8 GiB stage cache). First
   two chunks of it are staged into a block freed while queued work on
   the current stream still writes it, and must land intact. It fails
   unless the stage ends READY with the device's allocation growing by at
   most the volume + 2 chunks, the staged tensor equals the file byte for
   byte, a restage after unstage is served from the cache (no plane call,
   the same storage), a stage unstaged after FED_CANCEL_AT landed bytes
   ends FAILED "unmapped during staging", and after eviction
   ``memory_allocated`` is back where the phase began, and unless the
   cold stage read through the native engine (``read_path()``); then the
   Trainer of phase 5 runs STEPS steps on ``volume_token_batches`` of the
   staged volume, with phase 5's checks (finite losses, the first near
   ln(vocab), K1-K3 at LAYERS x STEPS launches each, all on ``wgmma``).
   It prints the stage's time, GB/s and breakdown (disk_s, h2d_s,
   dispatch_s), yardsticks timed in the same run (a pinned 64 MiB copy to
   the card; the file read alone into a torch-pinned 64 MiB buffer by
   each read engine, native with 8 threads, io_uring and preadv threads,
   in two rounds of turned order, each read byte-checked against the
   file, an engine the host refuses
   recorded as "unavailable: <errno>"; all from a warm page cache) and
   the stage's bound from the H2D and the fastest engine, the cache-hit
   time, and step_s and MFU beside phase 5's; then the ``oim_fed`` JSON
   line (``read_gbps_by_engine``). Read back: ``oim_staged_bytes_total``
   must rise by exactly the bytes of each stage, each engine's reads and
   none for a cache hit, the stage-cache hit, miss and eviction counters
   equal the backends' ``StageCache.stats()``, the flight recorder hold
   one ``stage_cache_eviction`` for each eviction, and
   ``oim_stage_seconds_total`` rise. Then the control plane's device half
   (the gRPC half needs grpcio, which the card machine lacks, and is held
   against the JAX services on the CPU by the tests): ReadVolume's byte
   window (``controller.backend.read_window``) of the staged volume, the
   first WINDOW bytes, an odd 7,013-byte window at WINDOW - 3 and the last
   WINDOW_TAIL bytes through ``length=0``, and the same windows of a
   64 MiB ``bfloat16`` volume staged alongside, each equal to the file's
   bytes; WINDOW_TIMED windows of 64 MiB timed by the host clock (GB/s)
   beside a pinned 64 MiB D2H by CUDA events, with no device growth and
   host RSS growing by at most WINDOW_RSS_LIMIT; then the windowed feed
   (``data.feeds.windowed_batches`` over ``read_window``, FEED_WINDOW =
   24,000-byte windows, a multiple of neither the record nor the batch)
   trains phase 8's config for STEPS steps with phase 5's checks, and its
   losses must equal phase 8's in-place losses to the bit; its feed wait
   and step_s are printed beside phase 8's.
9. OIM-fed ResNet-50, bench.py's cell at full width (bench.py:333-342,
   :426-500): 1024 seeded uint8 images [1024,224,224,3] written raw to a
   temporary directory, staged through ``CUDABackend`` and checked byte
   for byte; the Trainer on resnet50 (bf16, batch 128 sliced in place from
   the staged tensor at bench.py's offsets, 1000 classes) for 8 steps with
   a checkpoint every 4. It fails unless every loss is finite, the first
   within 1.0 of ln 1000, every BN running statistic finite and moved, and
   no K1-K3 kernel launched; then two eval batches in inference mode
   (finite loss, accuracy in [0, 1], the BN state byte-identical after); a
   fresh Trainer resumed from the step-4 checkpoint (the step-8 one
   removed, a partial temporary one left) must restore every tensor byte
   for byte and repeat steps 5-8's losses within RESNET_REL_TOL; one remat
   step from a copy of the state must repeat the plain step's loss,
   grad_norm and updated params within RESNET_REL_TOL and its gradients
   within RESNET_GRAD_TOL (worst leaf); phase 5's llama with ``--remat`` must launch K1 2 x
   layers x steps times and K2/K3 layers x steps, all on ``wgmma``, with
   phase 5's losses within RESNET_REL_TOL. It prints step_s, images/s,
   MFU, peak memory, the stage, checkpoint save and restore times, and the
   ``resnet`` JSON line. ``--profile`` adds one profiled ResNet step by
   category (``chiprun_out/chip_smoke_resnet_profile.json``).
10. MoE agreement (llama.tiny with 4 experts, f32, TF32 off): the card
   against the CPU for ``loss_and_stats`` (loss and ``moe_drop_frac``)
   and its gradients, ``moe.apply`` in both dispatch modes at capacity
   factor 0.5 (drops) and at k=1 (out, [aux, dropped], gradients), greedy
   ``generate()`` tokens and the paged steps' logits; it prints each
   fixture's smallest top-k router margin (``moe.router_margin``), so that a
   flipped route cannot pass as noise.
11. MoE main path: the MoE flagship (``MOE_OVERRIDES``: scripts/
   sweep_moe.py's config, 1.85e9 parameters, 1.04e9 active) at full width
   and depth through the trainer CLI, B=BATCH, T=SEQ, bf16, gather
   dispatch, MOE_STEPS steps. It fails unless every loss is finite, the
   first within 1.0 of ln 32768, ``moe_drop_frac`` is reported every step
   in [0, 1), and K1-K3 each launch 8 x MOE_STEPS times, all on ``wgmma``.
   From one state and batch it then holds einsum dispatch against gather
   layer by layer (each layer's FFN input from a gather forward through
   both modes: out within BF16_REL_TOL x max|out|, [aux, dropped] equal;
   the first layer's input and routes equal between the two models'
   forwards; each layer's share of flipped top-k routes printed) and
   takes one step plain, again plain (the card's spread), with einsum
   dispatch (loss and grad_norm within MOE_DISPATCH_REL of gather, the
   worst gradient leaf within MOE_DISPATCH_GRAD_REL) and with ``--remat
   --remat-policy dots_with_no_batch_dims`` (phase 9's remat limits on
   loss, grad_norm, gradients and params). It prints the parameter counts, step_s,
   tokens/s, MFU on active FLOPs and peak memory. The trainer's gauges
   (``oim_moe_drop_fraction`` among them) must equal its last logged
   step's values and the span ring hold one ``train.step`` span for each
   step. ``--profile`` adds one
   profiled step (``chiprun_out/chip_smoke_moe_profile.json``).
12. MoE serving: ``ServeEngine`` on the MoE flagship (full depth, bf16,
   weights from ``llama.init`` on the card), 10 seeded greedy requests
   (phase 7's 8 prompt lengths, two more sharing a 512-token prefix, the
   second sent after the first retired). It fails unless every request
   ends by length, the prefix store hits, and the pool is empty after
   drain and eviction; then phase 7's measurements (greedy agreement with
   solo ``generate()``, reported; the 8-row batch's first-decode logits
   within SERVE_LOGIT_REL x max|logit| of solo ``cached_forward``, the
   decode step's time beside its bound, which reads all four experts'
   weights; solo prefill by bucket) and the decode rows' smallest router
   margin. Phase 7's read-backs of outcomes, tokens, first tokens, prefix
   hits, pages and spans hold here too. ``--profile`` adds one profiled decode step
   (``chiprun_out/chip_smoke_moe_serve_profile.json``).
13. oim-infer: the trainer CLI writes a llama-tiny-moe checkpoint on the
   card, ``oim_infer.main`` restores it, and its greedy rows must equal
   ``generate()`` on the restored params; a directory with no checkpoint
   must exit nonzero.
14. sources: the data plane's other sources staged through
   ``CUDABackend()`` on the card from a temporary directory (which must
   have room) and a loopback object gateway (a ThreadingHTTPServer
   answering HEAD, ranged GET and ETag, with HTTP Basic auth where an
   object asks for it), each volume >= 1 GiB (``phase_sources`` lists the
   cuts). TFRecord: 8 ImageNet-style shards of framed tf.Examples staged
   on the native engine, equal to the files on the card, walked back with
   ``iter_tfrecord_bytes`` + ``parse_example`` (count and every label as
   written), restaged as a cache hit with no plane call. webdataset by
   ``http://`` URL: 4 tar shards of ``.bin`` members of SEQ + 1 int32
   tokens, equal to the shards, the tokens recovered by ``_wds_tokens``
   equal to those written, an unchanged restage a hit, a shard whose
   bytes and ETag change a miss and a restage equal to the new bytes;
   then phase 5's Trainer for STEPS steps on those tokens with phase 5's
   checks. ceph: one 1 GiB object behind Basic auth (``CephParams``),
   equal to the object; with a wrong secret the volume ends FAILED with
   the gateway's 401 and ``memory_allocated`` is back where it was. Each
   kind prints its stage GB/s and breakdown against its bound (the slower
   of its source read alone and the pinned H2D); the ``sources`` JSON
   line carries them. Phase 8's staging read-backs hold for each kind.
15. multi-rank training on the one card (``phase_parallel``). The card
   holds one device and NCCL refuses two ranks on one, so two ranks
   share ``cuda:0`` over gloo and NCCL runs at world size 1: a check of
   the multi-GPU path, not a multi-GPU speed. Ranks are spawned processes
   (a FileStore rendezvous) that only load the kernels phase 2 built;
   each job has a time limit, and a rank that fails fails the run.
   First one rank's history (STEPS steps) of the zigzag run's global
   batch (B=1, T=2 x SEQ) in this process; phase 5's is dp's and fsdp's.
   NCCL, world 1: each collective of ``parallel/collectives.py`` once on
   a CUDA tensor, equal to its value and staging nothing; then phase 5's
   config for 2 steps through the meshed path (``--mesh data=1``), whose
   losses and grad norms must equal phase 5's first two to the bit
   (size-1 axes are elided, so the step makes no collective call). gloo,
   2 ranks: the collectives on CUDA tensors equal to their values; ring,
   zigzag and Ulysses attention at llama3-8b's width (q [1,4096,32,128],
   k/v [1,4096,8,128], bf16, causal, 2048 positions a rank) against the
   plain versions of K1-K3 over all 4096 on one rank (output within
   phase 3's K1 tolerance, dq/dk/dv within its K2/K3 tolerance), with
   each rank's K1-K3 launches equal to the schedule's (ring 1 and 2,
   zigzag 2 and 2, Ulysses 1 and 1; K2 = K3 = K1), all on ``wgmma``; then
   the trainer CLI for STEPS steps under ``--rules dp --mesh data=2``,
   ``--rules fsdp --mesh data=1,fsdp=2`` (B=2) and ``--rules tp_sp
   --mesh data=1,fsdp=1,seq=2,model=1 --seq-parallel zigzag`` (B=1, T=2
   x SEQ; the JAX trainer refuses a mesh that lacks an axis its rules
   name, and so does the port) and ``--rules tp_sp --mesh
   data=1,fsdp=1,seq=1,model=2`` (tensor parallelism, the same row; its
   attention at 16/4 heads a rank, its collective calls and bytes equal
   to ``tp_collectives``' count written down before the run). Each run:
   every loss finite and equal on
   both ranks, every step's loss and grad_norm within PAR_LOSS_REL and
   PAR_NORM_REL of one rank on the same global batch and initial params,
   K1-K3 at LAYERS x STEPS launches a rank (twice that for zigzag), all
   ``wgmma``, every leaf piece held by both ranks equal by a digest of
   its bits after the last step, and under fsdp and tensor parallelism
   each rank holding half the bytes of the split leaves (embed and
   lm_head among them) plus the norms held whole. Last, the faults of
   PAR_FAULTS are planted in the ranks' trainer one at a time (each rank
   on its own rows only; the gradients' sum over data dropped; zigzag's
   tokens at contiguous RoPE positions; the plain psum in place of
   ``reduce_from``), and each must break one of those two limits. It prints per-rank step_s and
   peak memory, the backend, the collectives' calls and bytes, those
   staged through host memory apart, and each fault's readings.
   Then MoE, ResNet and checkpoints across the two ranks, each run
   against one rank on its global batch and initial params within
   PAR_LOSS_REL / PAR_NORM_REL at every step, losses equal on both ranks
   and replicas equal by digest: (a) the MoE flagship at full width and
   depth under ``--rules tp_sp --mesh data=1,fsdp=1,seq=1,model=1,
   expert=2`` (against phase 11's run; each rank holding two experts'
   bytes plus the replicated leaves; moe_drop_frac within one routing
   assignment of phase 11's; K1-K3 at 8 x MOE_STEPS launches a rank on
   ``wgmma``; collective calls and bytes equal to ``ep_collectives``'
   count, written down before the run); (b) the flagship cut to
   MOE_FSDP_LAYERS layers under ``--rules fsdp --mesh data=1,fsdp=2``
   (one row a rank: the global routing), in float32 (SLICE12_DTYPE: in
   bf16 a rank's partial gradients round before their sum, and the run
   parts from one rank's by more than the limits once routes flip after
   an update), K1-K3 on their fma route; (c) ResNet-50 at bench.py's cell
   (batch 128, synthetic images) in float32 for the same reason under
   ``--rules dp --mesh data=2``, within RESNET_PAR_LOSS_REL and
   RESNET_PAR_NORM_REL (in the PAR limits' place: its sound runs move
   between calls), its BN running statistics equal on both
   ranks and within RESNET_BN_REL of one rank's, and no K1-K3 launch; (d)
   (a) and (b)
   checkpointed at step 2 (each rank its pieces, ``train/checkpoint.py``)
   and resumed: (b) on the same mesh, steps 3-4 and the final params
   equal to the unbroken run's to the bit, and on one process, as (a) is,
   within the limits of one rank's steps 3-4; a blocking save's seconds
   and piece bytes a rank and each restore's seconds printed. Last the
   faults of SLICE12_FAULTS (each rank routing its own tokens, in (b)
   at capacity factor MOE_FSDP_CF, against one rank there; the
   router's columns through the plain all_gather; a per-rank batch norm;
   the load-balance loss in full on every rank), each of which must break
   one of the limits.
   Then pipeline parallelism over ``--rules pipe --mesh data=1,pipe=2``
   at llama3-8b width, PIPE_LAYERS layers (2 a stage), B=PIPE_BATCH,
   M=PIPE_M microbatches, bf16: (e) GPipe, (f) 1F1B and (g) interleaved
   1F1B (``--virtual-stages 2``, one layer a chunk), each against one
   rank's dp run of the same configuration; (h) the MoE flagship (8
   layers, 4 a stage) under 1F1B at B=2, M=2 in float32 (PIPE_F32: in
   bf16 each rank's dy partial rounds before the sum over pipe and routes
   flip after an update) against one rank under rules pipe over pipe=1 at
   the same M (capacity is per microbatch), its moe_drop_frac within one
   assignment. Each within PAR_LOSS_REL /
   PAR_NORM_REL at every step, its losses equal on both ranks, replicas
   equal by digest, each rank holding half the split leaves (layers,
   embed's and lm_head's vocabulary) plus final_norm whole; K1-K3
   launches a rank at the schedule's count (layers a stage x M x STEPS
   for K2/K3 and GPipe's K1, twice that for 1F1B's K1: its backward
   recomputes the stage), all ``wgmma`` ((h)'s on ``fma``); 1F1B's stash
   peak at the schedule's stash_x (at most it, interleaved). One step's
   memory a rank (allocated at its start, peak) of GPipe and 1F1B at
   M=PIPE_M and at M=PIPE_M_WIDE (B=M) is printed: the memory law. Last PIPE_FAULTS (the interleaved run on the
   canonical layer order; the MoE aux counted on idle ticks too), each
   of which must break a limit.
   Last slice 14's runs (``slice14_job``). (i) An int32 token volume
   [PLACE_N, BATCH, SEQ + 1] (its first STEPS batches phase 5's) staged
   by each rank through its own ``CUDABackend(mesh=data=2)`` with
   sharding_axes ["", "data", ""]: a ``plane.Placed`` holding this
   rank's coordinate only, its rows of the file byte for byte, PLACE_N
   (= MAX_RUNS) runs and the rank's bytes read (counted at the file
   reader), one plane call, ``placement_bytes``, the
   volume's total and ``oim_staged_bytes_total``'s rise all the rank's
   bytes, the device's allocation grown by at most the slice plus two
   chunks, a restage served by the cache (no plane call, the same
   storage); then phase 5's config under ``--rules dp --mesh data=2`` fed
   ``vol[i]`` with place_batch handing back the staged storage at every
   step, within PAR_LOSS_REL / PAR_NORM_REL of phase 5 at every step,
   K1-K3 at LAYERS x STEPS a rank on ``wgmma``; then the same layout at
   PLACE_FALLBACK_N batches, past MAX_RUNS, through the whole-read
   fallback, equal to the file. Stage seconds, GB/s and breakdown a rank
   are printed beside phase 8's. (j) ``--rules tp_sp --mesh
   data=1,fsdp=1,seq=1,model=2`` on HEADSPLIT_MODEL (3 query heads of
   128 over 2 ranks: a head straddles them), B=1, T=HEADSPLIT_T, against
   one rank at every step within the limits, attention at (2, 1) heads
   a rank, K1-K3 at LAYERS x STEPS a rank on ``wgmma``, each rank
   holding half the split leaves, replicas equal by digest; the planted
   ``gather_from`` in place of q's gather must break a limit.
16. the serving daemon's device half (``phase_serve_daemon``): importing
   ``oim_tpu_torch.cli.oim_serve`` loads no ``grpc`` and no
   ``google.protobuf``; llama3-8b at full width cut to DAEMON_LAYERS
   layers, bf16, drawn on the card and packed to a temporary file
   (``save_packed``, the ``--pack-to`` artifact), staged through
   ``CUDABackend`` as the raw uint8 file volume ``weights_request``
   describes, then restored by ``restore_from_array`` (the grpc-free core
   of ``restore_weights``) whole and as members 0 and 1 of shard 2. Every
   restored leaf must equal the original to the bit, each member tree
   ``member_params``' piece, ``LAST_RESTORE["bytes_staged"]`` the member
   weight bytes, and a ``ServeEngine`` on the restored tree must stream
   the same tokens as one on the original params for DAEMON_PROMPTS'
   greedy requests. It prints the blob's bytes, the stage's seconds and
   GB/s beside its bound (the slower of the file read alone and a pinned
   H2D), the restore's seconds, how many leaves it copied (an offset in
   the blob that the element size does not divide) and the device and
   host growth over the stage and the restore; the ``serve_daemon`` JSON
   line.
17. KV handoff, the fleet KV tier (``phase_kv_handoff``): llama3-8b at
   full width and depth, bf16, phase 7's weights drawn again from its seed
   (0.1-0.4 s; held through phases 8-16 they would crowd phase 15's ranks),
   three engines of phase 7's geometry without the host tier (KV_ENGINE):
   ``prefill`` (``prefill_chunk`` KV_CHUNK), ``decode`` and a ``mixed``
   reference (the same chunk), and one KV_PROMPT-token prompt (96 full
   blocks, 201,326,592 B of K/V). The prefill engine's retirement exports
   the chain through ``kvvolume.export_chain_to`` (the grpc-free core of
   ``export_chain``), staged through ``CUDABackend`` as the raw uint8 file
   volume ``chain_request`` describes (``weights_params``' spec); the decode engine adopts it through
   ``kvvolume.ChainFetcher`` reading that volume back. It fails unless the
   retirement exports exactly one chain (``oim_serve_prefill_handoffs_total
   {exported}`` +1, one ``kv_chain_exported`` event), the decode engine
   adopts it (peer-fetch hit +1, ``oim_serve_prefix_peer_tokens_total``
   +96 x 16, one ``kv_peer_fetch`` event, 1,536 prefix tokens), its
   adopted pages read back by ``snapshot_chain`` equal the exported ones
   to the bit (and so must the mixed engine's own, the same chunked
   prefill). Each engine's own KV_NEW-token greedy stream is then held
   against one dense ``cached_forward`` over the prompt and that stream
   (``reference_logits``: no page pool, table, chunk or bucket): the
   logits the engine computed for each token (``engine_logits`` wraps
   its prefill and decode forwards) must lie within SERVE_LOGIT_REL x
   max|logit| of the reference's, and each token must be the reference's
   argmax or short of its top logit by at most that much
   (``hold_tokens``). Over pages equal to the bit and the same 1-token
   tail prefill, the decode engine's tokens and logits must equal the
   mixed engine's to the bit (a wrong page, slot or tail offset would
   pass the tolerance). Two planted defects,
   a blob cut in half and a fingerprint of page_tokens 32, must each
   record one ``kv_fetch_fallback`` with JAX's fields, one fetch error, no
   adoption, and a local recompute held the same way (its stream may part
   from the mixed one: ``parting`` reads the reference's top-2 gap where
   it does, and ``tail_probe`` computes the prompt's last position as a
   recompute and as the chained engines do, compared to the bit); and every engine's
   pool must be empty after drain and eviction. It prints, each the mean
   of KV_TRIALS: the export split into snapshot (D2H), pack, file write
   and stage; the adoption into the volume's read-back, unpack and
   ``stage_pages`` (its GB/s beside a pinned H2D); the decode engine's
   first token with adoption against a local recompute of the same
   prompt (the store evicted between trials); the device growth of each
   stage and adoption; and the ``kv_handoff`` JSON line.
18. ranks assembled from the registry, fed by the token stream. (b) A
   webdataset volume of REG_SHARDS tars (~64 MiB each) of ``.bin``
   members of SEQ + 1 seeded int32 tokens in llama3-8b's vocabulary, the
   last shard one row short (an odd row count, so a batch straddles the
   wrap) and ending in a REG_TAIL-token member, staged through
   ``CUDABackend``: its batches streamed a shard at a time
   (``feeds.wds_token_stream`` over ``read_window``, the grpc-free core
   of the feeder's streaming feed) must equal the whole volume's
   ``_cycle_token_batches`` to the bit for one epoch and REG_PAST_WRAP
   batches past the wrap, and a shard grown since staging must stop the
   stream with JAX's "shards changed since staging?" error. (a) Two
   spawned processes share the card, one a controller's trainer each:
   from one registry snapshot (REG_ENTRIES, a dict as GetValues returns
   it: host-1 at 0,0,0 and host-0 at 1,0,0) each derives its rank with
   ``bootstrap.derive_process_layout`` and joins through
   ``join_process_group`` at tcp://127.0.0.1:<free port> (gloo), then
   takes REG_STEPS dp steps at phase 5's width, one row a rank, on the
   stream's first batches. Both must agree on the coordinator and world,
   host-1 must be rank 0, each rank must train its row of each batch,
   and the two processes spawned again with a layout sorted by id alone
   (planted) must fail that row check after one step; the
   losses and grad norms must lie within PAR_LOSS_REL / PAR_NORM_REL of
   one rank's steps on the whole batches, and K1-K3 must launch LAYERS x
   REG_STEPS times a rank on wgmma. It prints the join time, the stage
   and stream rates and step_s, and the ``registry_stream`` JSON line.
19. the chaos ladder's engine rungs (``chaos.ladder.run_engine_rungs``,
   the grpc-free core of the ladder): ``pool_exhaustion`` and
   ``draft_collapse``, each in a fresh ``EngineSim`` on the card at the
   ladder's own model (llama.tiny, vocab 64, dim 32, 2 layers, f32; the
   rungs' page budgets and request streams), must each heal with its
   declared signature read over HTTP from the sim's metrics server
   (``page_pool_exhausted``; ``spec_fallback``), every stream equal to the
   port's ``solo_tokens`` on the card (a stream that differs fails with
   ``parting``'s position and top-2 gap), the pools empty and in budget,
   the valve closed and the census passing. ``fault_overhead`` runs at
   that model and at llama3-8b width, LAYERS layers, bf16; each
   ``fault_overhead_ratio`` must reach CHAOS_OVERHEAD_FLOOR (0.90). It
   prints each rung's wall time and details, both ratios with their pair
   spread, and the ``chaos`` JSON line.
20. the fleet SLO plane's decision (``obs/slo.py``, ``obs/merge.py``,
   ``autoscale/reconcile.py``, the grpc-free core of ``oim-monitor`` and
   ``oim-autoscaler``) fed by the card engines' own first-token
   histograms: max_batch=1 engines at llama3-8b width, LAYERS layers,
   bf16, each in a process of its own (r0, then r1 when the plan asks
   for it) publishing its ``metrics_snapshot`` row. A paced run sets the
   first-token SLO's ``threshold_s`` (the first bucket bound above 3x its
   p99) and moves nothing; a burst of 12 at once into r0's one slot must
   lie above it (p50) and fire the SLO once (``slo_alert_fired`` in the
   port's ring, ``oim_slo_burn_rate`` over the threshold); ``plan`` must
   answer one spawn ``alert:first_token_p99``, the phase's own
   ``ReplicaLauncher`` starts r1, and the burst split over r0 and r1 must
   give every stream of r0 alone to the bit and a lower p50; paced
   traffic past the resolve hold must resolve, and ``plan`` past the
   scale-down hold must drain r1, whose resident request finishes and
   whose queued one, closed "drained", r0 serves with the same stream.
   The SLO's windows and holds run on explicit clocks. It prints the
   paced p99, ``threshold_s``, the burn rates at the fire, both bursts'
   p50 and p99, spawn-to-ready and drain times, the phase's wall time,
   and the ``fleet_slo`` JSON line.
21. no ``grpc`` or ``google.protobuf`` module loaded by the run (the
   card's path needs neither); the host cost of one ``Histogram.observe``
   and one ``events.emit``;
   the main-path, serve, oim_fed, resnet, moe and sources lines, the
   ``obs`` line (every phase's read-backs, phase 5's step_s and phase
   7's and 12's decode step ms beside them), the ``parallel`` line (phase
   15), the ``serve_daemon`` line (phase 16), the ``kv_handoff`` line
   (phase 17), the ``registry_stream`` line (phase 18), the ``chaos``
   line (phase 19), the ``fleet_slo`` line (phase 20) and the kernels
   line (JSON),
   the card line, and the last line ``{"ok": true, "device": {...}}``. Beside the contract's keys each kernel record has
   ``parallel_launches`` (phase 15's, by path and rank),
   ``registry_launches`` (phase 18's, by rank),
   ``parallel_max_abs_err`` (phase 15's sequence-parallel attention
   against the plain versions on one rank: K1 its output, K2 dk and dv,
   K3 dq),
   ``oim_fed_launches`` (phase 8's launches),
   ``oim_fed_windowed_launches`` (phase 8's windowed feed's), ``sources_launches`` (phase
   14's), ``resnet_launches`` and
   ``llama_remat_launches`` (phase 9's), ``moe_launches`` and
   ``moe_routes`` (phase 11's), ``max_abs_err_by_path`` (phase 3's
   error at each path's shape; ``max_abs_err`` is the largest), ``routes`` (the main path's
   launches by kernel route,
   e.g. ``{"wgmma": 8, "fma": 0}``), ``tflops``, ``fma_route_ms`` (the
   CUDA-core kernel on the same inputs) and ``resources`` (registers,
   spills, shared memory and blocks per SM of the route the main path
   took, from the CUDA runtime).

It refuses to run without a CUDA device, and outside a checkout of the
repository (it imports the port from the directory it sits in).
"""

from __future__ import annotations

import argparse
import base64
import bisect
import collections
import contextlib
import http.server
import io
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tarfile
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core rate and HBM3
# bandwidth; a bound is the larger of operations/peak and bytes/bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# Kernel vs plain version: both sum in f32 and round P and dS to bf16 at
# the same points, so bf16 outputs differ by one f32 summation order
# against another (and an input to a rounding that lands on the other side
# of a bf16 step): a few bf16 ulps (2^-7 relative) of the largest value.
BF16_REL_TOL = 2.0 ** -6
F32_ABS_TOL = 1e-4  # f32 outputs (lse) and f32 odd cases

# The main path's cell: llama3-8b width, depth cut to 2 layers (the
# trainer's own dryrun cut), batch 2 x 2048 tokens, 4 steps.
LAYERS, BATCH, SEQ, STEPS = 2, 2, 2048, 4
ITERS = 10  # timed launches per kernel

KERNELS = (
    # name, TPU kernel it replaces (file:line of its pallas_call)
    ("flash_fwd", "oim_tpu/ops/attention.py:198"),
    ("flash_bwd_dkv", "oim_tpu/ops/attention.py:380"),
    ("flash_bwd_dq", "oim_tpu/ops/attention.py:418"),
)


def fail(msg: str, code: int = 1):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(code)


def say(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi exit {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device ms of fn() over iters launches, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def causal_pairs(tq: int, tk: int, causal: bool) -> int:
    """(query, key) pairs the mask keeps: bottom-right aligned causal."""
    if not causal:
        return tq * tk
    off = tk - tq
    return sum(min(tk, max(0, i + off + 1)) for i in range(tq))


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check(name: str, got, want, tol: float, errors: list):
    err = max_err(got, want)
    ok = err <= tol and bool(got.isfinite().all())
    say(f"  {name:<26s} max_abs_err {err:.3e}  tol {tol:.3e}  {'ok' if ok else 'FAILED'}")
    if not ok:
        errors.append(f"{name}: max_abs_err {err} > {tol}")
    return err


def attention_inputs(b, tq, tk, h, hkv, d, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, device="cuda", generator=g).to(dtype)  # noqa: E731
    return mk(b, tq, h, d), mk(b, tk, hkv, d), mk(b, tk, hkv, d), mk(b, tq, h, d)


def phase_kernels(shapes: dict, odd_cases) -> list[dict]:
    """Phase 3: the odd cases, then each driven path's attention call
    (``shapes``: path -> run_case's arguments, bf16), each on the wgmma
    route its path's launch gate demands; returns one record per kernel,
    timed at the first path's call (a causal square)."""
    import importlib

    import torch
    import torch.nn.functional as F

    from oim_tpu_torch import kernels

    # the module, not the `attention` function ops/__init__ exports
    A = importlib.import_module("oim_tpu_torch.ops.attention")

    errors: list[str] = []

    def run_case(b, tq, tk, h, hkv, d, causal, dtype, seed, lse_cotangent=False):
        q, k, v, do = attention_inputs(b, tq, tk, h, hkv, d, dtype, seed)
        scale = d ** -0.5
        ref_out, ref_lse = A.flash_forward_plain(q, k, v, causal, scale)
        # delta as the autograd Functions form it: rowsum(dO * O) in f32,
        # less the lse cotangent where lse is an output too
        delta = (do.float() * ref_out.float()).sum(-1)
        if lse_cotangent:
            g = torch.Generator(device="cuda").manual_seed(seed + 1000)
            delta = delta - torch.randn(delta.shape, device="cuda", generator=g)
        delta = delta.permute(0, 2, 1).reshape(b * h, tq).contiguous()
        ref_dk, ref_dv = A.flash_bwd_dkv_plain(q, k, v, do, ref_lse, delta, causal, scale)
        ref_dq = A.flash_bwd_dq_plain(q, k, v, do, ref_lse, delta, causal, scale)
        route = kernels.bwd_route(q, k, v, do)
        rule = {"flash_fwd": kernels.fwd_route(q, k, v),
                "flash_bwd_dkv": route, "flash_bwd_dq": route}
        before = {n: dict(kernels.ROUTES[n]) for n in rule}
        out, lse = kernels.flash_fwd(q, k, v, causal, scale)
        dk, dv = kernels.flash_bwd_dkv(q, k, v, do, ref_lse, delta, causal, scale)
        dq = kernels.flash_bwd_dq(q, k, v, do, ref_lse, delta, causal, scale)
        torch.cuda.synchronize()
        for n, seen in before.items():
            took = [r for r, c in kernels.ROUTES[n].items() if c != seen[r]]
            if took != [rule[n]]:
                errors.append(f"{n} took route {took}, the rule says {rule[n]}")
        rel = BF16_REL_TOL if dtype == torch.bfloat16 else 0.0

        def tol(ref):
            return rel * float(ref.abs().max()) + (F32_ABS_TOL if rel == 0 else 0.0)

        tag = f"b{b} tq{tq} tk{tk} h{h}/{hkv} d{d} {'causal' if causal else 'full'} " \
              f"{str(dtype).removeprefix('torch.')}{' lse-cotangent' if lse_cotangent else ''}" \
              f"  K1 route {rule['flash_fwd']}, K2/K3 route {route}"
        say(f" case {tag}")
        errs = {
            "flash_fwd": max(check("K1 out", out, ref_out, tol(ref_out), errors),
                             check("K1 lse", lse, ref_lse, F32_ABS_TOL, errors)),
            "flash_bwd_dkv": max(check("K2 dk", dk, ref_dk, tol(ref_dk), errors),
                                 check("K2 dv", dv, ref_dv, tol(ref_dv), errors)),
            "flash_bwd_dq": check("K3 dq", dq, ref_dq, tol(ref_dq), errors),
        }
        return errs, (q, k, v, do, ref_out, ref_lse, delta, scale)

    for case in odd_cases:
        run_case(*case)
    if errors:
        fail("odd cases: " + "; ".join(errors))

    by_path, timed = {}, None
    for path, case in shapes.items():
        say(f" {path}:")
        by_path[path], tensors = run_case(*case)
        if kernels.bwd_route(*tensors[:4]) != "wgmma":
            errors.append(f"the {path} path's shape takes route "
                          f"{kernels.bwd_route(*tensors[:4])}, its gate wants wgmma")
        timed = timed or tensors
        del tensors
    if errors:
        fail("kernels disagree with their plain versions: " + "; ".join(errors))
    q, k, v, do, out, lse, delta, scale = timed
    b, t, h, d = q.shape
    hkv = k.shape[2]
    errs = {name: max(e[name] for e in by_path.values()) for name, _ in KERNELS}

    # Timings at the main path's shape. Plain versions repeat the kernels'
    # arithmetic in torch ops (no speed yardstick). The library yardstick:
    # scaled_dot_product_attention with an explicit bottom-right causal
    # mask on K/V expanded to q's heads (expansion outside the timing).
    group = h // hkv
    mask = A._causal_mask(t, t, q.device)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k.repeat_interleave(group, 2),
                                               v.repeat_interleave(group, 2)))
    lib_fwd = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)  # noqa: E731
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (qh, kh, vh))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
    dog = do.transpose(1, 2)
    lib_bwd = lambda: torch.autograd.grad(lib_out, (qg, kg, vg), dog,  # noqa: E731
                                          retain_graph=True)
    pairs = causal_pairs(t, t, True) * b * h
    esz = q.element_size()
    qb, kvb, rowb = q.numel() * esz, k.numel() * esz, b * h * t * 4
    fns = {
        "flash_fwd": (lambda: kernels.flash_fwd(q, k, v, True, scale),
                      lambda: A.flash_forward_plain(q, k, v, True, scale),
                      lib_fwd, 2 * 2 * d * pairs, 2 * qb + 2 * kvb + rowb),
        "flash_bwd_dkv": (lambda: kernels.flash_bwd_dkv(q, k, v, do, lse, delta, True, scale),
                          lambda: A.flash_bwd_dkv_plain(q, k, v, do, lse, delta, True, scale),
                          lib_bwd, 4 * 2 * d * pairs, 2 * qb + 4 * kvb + 2 * rowb),
        "flash_bwd_dq": (lambda: kernels.flash_bwd_dq(q, k, v, do, lse, delta, True, scale),
                         lambda: A.flash_bwd_dq_plain(q, k, v, do, lse, delta, True, scale),
                         lib_bwd, 3 * 2 * d * pairs, 3 * qb + 2 * kvb + 2 * rowb),
    }
    # The first port's CUDA-core kernels on the same inputs, beside the
    # tensor-core route the rule picks here.
    earlier = {
        "flash_fwd": lambda: kernels.flash_fwd(q, k, v, True, scale, route="fma"),
        "flash_bwd_dkv": lambda: kernels.flash_bwd_dkv(q, k, v, do, lse, delta, True, scale,
                                                       route="fma"),
        "flash_bwd_dq": lambda: kernels.flash_bwd_dq(q, k, v, do, lse, delta, True, scale,
                                                     route="fma"),
    }
    main_route = kernels.bwd_route(q, k, v, do)  # K1's too: one rule
    resources = {}
    for name in earlier:
        for r, hd in (("wgmma", 128), ("wgmma", 64), ("fma", d)):
            info = kernels.kernel_info(name, r, hd)
            if hd == d:
                resources.setdefault(name, {})[r] = info
            say(f"  {name:<14s} {r:<5s} route{f' head_dim {hd}' if r == 'wgmma' else '':<13s}: "
                f"{info['registers']} registers, {info['local_bytes']} B local (spills), "
                f"{info['smem_bytes']} B shared, {info['blocks_per_sm']} blocks per SM")
    records = []
    for name, replaces in KERNELS:
        kern, plain, lib, flops, nbytes = fns[name]
        ms = cuda_ms(kern, ITERS)
        plain_ms = cuda_ms(plain, ITERS // 4)
        ms2 = cuda_ms(kern, ITERS)  # kernel, plain, kernel: a drift shows
        library_ms = cuda_ms(lib, ITERS)
        fma_ms = cuda_ms(earlier[name], ITERS // 2)
        bound_ms, bound_by = bound(flops, nbytes)
        best = min(ms, ms2)
        say(f"  {name:<14s} kernel {ms:.3f}/{ms2:.3f} ms  plain {plain_ms:.3f} ms  "
            f"library {library_ms:.3f} ms  bound {bound_ms:.4f} ms ({bound_by}; "
            f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)  "
            f"{flops / (best * 1e-3) / 1e12:.1f} TFLOP/s  fma route {fma_ms:.3f} ms")
        records.append({
            "name": name, "route": "cuda",
            "source": f"oim_tpu_torch/kernels/csrc/{kernels.SOURCES[name]}",
            "replaces": replaces, "launches": None, "max_abs_err": errs[name],
            "max_abs_err_by_path": {path: e[name] for path, e in by_path.items()},
            "ms": best, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "routes": None,
            "tflops": flops / (best * 1e-3) / 1e12, "fma_route_ms": fma_ms,
            "resources": resources[name][main_route],
            "library": ("scaled_dot_product_attention forward, explicit bottom-right mask"
                        if name == "flash_fwd" else
                        "scaled_dot_product_attention backward (dq, dk and dv in one call), "
                        "explicit bottom-right mask"),
        })
    del lib_out
    torch.cuda.empty_cache()
    return records


def build_read_engine() -> dict:
    """Phase 2's second half: the C++ read engine compiled from
    ``native/staging.cc`` into ``oim_tpu_torch/data/build/`` and loaded."""
    from oim_tpu_torch.data import staging

    cxx = staging.compiler()
    try:
        version = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                                 timeout=60).stdout.splitlines()[0]
    except (OSError, IndexError) as e:
        fail(f"the read engine's compiler {cxx!r} does not run: {e}")
    jpeg = staging.has_jpeg()
    t0 = time.monotonic()
    try:
        lib = staging.build()
    except staging.StagingError as e:
        fail(f"the native read engine did not build: {e}")
    build_s = time.monotonic() - t0
    if staging.native_lib() is None:
        fail(f"the native read engine at {lib} does not load")
    say(f"  read engine: {lib.relative_to(ROOT)} from native/staging.cc in {build_s:.1f} s "
        f"({version}; libjpeg {'found: -ljpeg' if jpeg else 'not found: no JPEG decoder'})")
    return {"path": str(lib.relative_to(ROOT)), "compiler": version, "libjpeg": jpeg,
            "build_s": build_s}


def phase_agreement():
    """Phase 4: llama.tiny on the card against the same model on the CPU."""
    import dataclasses

    import torch

    from oim_tpu_torch.models import llama
    from oim_tpu_torch.train.state import tree_leaves

    cfg = dataclasses.replace(llama.tiny(), vocab_chunk=96)
    params = llama.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 130), generator=torch.Generator().manual_seed(1))
    results = {}
    for dev in ("cpu", "cuda"):
        p = {k: ({n: w.detach().to(dev) for n, w in v.items()} if isinstance(v, dict)
                 else v.detach().to(dev)) for k, v in params.items()}
        leaves = list(tree_leaves(p))
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss, _ = llama.loss_and_stats(p, tokens.to(dev), cfg)
        grads = torch.autograd.grad(loss, leaves)
        loss = loss.detach()
        results[dev] = (loss.item(), [g.detach().cpu() for g in grads])
    loss_err = abs(results["cpu"][0] - results["cuda"][0])
    grad_err = max(max_err(a, b) for a, b in zip(results["cpu"][1], results["cuda"][1]))
    say(f"  llama.tiny f32 (T=129, ragged tiles): loss cpu {results['cpu'][0]:.6f} "
        f"cuda {results['cuda'][0]:.6f} |diff| {loss_err:.2e}; grads max |diff| {grad_err:.2e}")
    if not (loss_err <= 1e-4 and grad_err <= 1e-4 and math.isfinite(results["cuda"][0])):
        fail(f"llama.tiny on the card disagrees with the CPU: loss {loss_err}, grads {grad_err}")


def main_path_argv() -> list[str]:
    return ["--model", "llama3-8b", "--override", f"n_layers={LAYERS}",
            "--steps", str(STEPS), "--batch-size", str(BATCH), "--seq-len", str(SEQ),
            "--warmup-steps", "2", "--log-every", "1", "--log-level", "info"]


def phase_main_path(profile: bool) -> dict:
    """Phase 5: the CLI's Trainer at llama3-8b width."""
    layers, steps, batch, seq = LAYERS, STEPS, BATCH, SEQ
    import torch

    from oim_tpu_torch import kernels
    from oim_tpu_torch.cli import oim_trainer
    from oim_tpu_torch.models import llama

    from oim_tpu_torch.common import tracing

    trace_dir = tempfile.mkdtemp(prefix="oim-trace-")
    argv = main_path_argv() + ["--trace-dir", trace_dir]
    say(f"  python -m oim_tpu_torch.cli.oim_trainer {' '.join(argv)}")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.monotonic()
    trainer = oim_trainer.run(argv)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    spans = tracing.load_trace_file(
        os.path.join(trace_dir, f"oim-trainer-{os.getpid()}.trace.json"))
    obs = check_train_gauges(trainer.history, spans, steps, "main path")
    shutil.rmtree(trace_dir, ignore_errors=True)
    launches = dict(kernels.LAUNCHES)
    routes = {name: dict(r) for name, r in kernels.ROUTES.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    hist = trainer.history
    losses = [r["loss"] for r in hist]
    mcfg = trainer.cfg.model_config()
    say(f"  losses {losses}")
    say(f"  launches {launches}  (want {layers} x {steps} = {layers * steps} each)")
    say(f"  routes {routes}  (want every launch on wgmma)")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        fail(f"main path: losses not finite or missing: {losses}")
    if abs(losses[0] - math.log(mcfg.vocab)) > 1.0:
        fail(f"main path: first loss {losses[0]} not near ln(vocab) {math.log(mcfg.vocab):.3f}")
    for name, _ in KERNELS:
        if launches[name] != layers * steps:
            fail(f"main path: {name} launched {launches[name]} times, "
                 f"want {layers * steps}")
    for name, _ in KERNELS:
        if routes[name]["wgmma"] != layers * steps:
            fail(f"main path: {name} took routes {routes[name]}, want all "
                 f"{layers * steps} on wgmma")
    steady = hist[1:] if len(hist) > 1 else hist
    step_s = sum(r["step_s"] for r in steady) / len(steady)
    tokens = batch * seq
    mfu = sum(r["mfu"] for r in steady) / len(steady)
    say(f"  step_s {step_s:.4f} (steps 2..{steps}; step 1 {hist[0]['step_s']:.4f})  "
        f"tokens/s {tokens / step_s:.0f}  MFU {mfu:.4f} of 989e12  "
        f"params {llama.num_params(mcfg) / 1e9:.3f}e9  peak mem {peak_gb:.1f} GB  "
        f"wall {wall:.1f} s")
    result = {"launches": launches, "routes": routes, "step_s": step_s, "mfu": mfu,
              "losses": losses, "tokens_per_s": tokens / step_s, "peak_mem_gb": peak_gb,
              "obs": obs, "history": hist}
    if profile:
        result["profile"] = profile_step(trainer)
    return result


def _category(kernel: str) -> str:
    name = kernel.lower()
    if "oimflash" in name:
        return "attention kernels (K1-K3)"
    if any(k in name for k in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "matmuls (cuBLAS)"
    if "reduce" in name or "norm" in name:
        return "reductions"
    if any(k in name for k in ("index", "scatter", "gather", "embedding")):
        return "index, gather and scatter (embedding, MoE dispatch)"
    return "elementwise and copies"


OPTIMIZER_RANGE = "optimizer (AdamW)"


@contextlib.contextmanager
def patched(owner, attr: str, wrap):
    """Within the block, ``owner.attr`` is ``wrap(the original)``."""
    orig = getattr(owner, attr)
    setattr(owner, attr, wrap(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def in_range(name: str):
    """A ``patched`` wrap: every call runs under a record_function range."""
    from torch.profiler import record_function

    def wrap(fn):
        def ranged(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return ranged
    return wrap


def moe_calls(calls: list):
    """A ``patched`` wrap for ``moe.apply``: each call appends (its layer's
    MoE params, its input detached, its MoEConfig) to ``calls`` first."""
    def wrap(apply):
        def spy(params, x, cfg, with_stats=False, **kw):
            calls.append((params, x.detach(), cfg))
            return apply(params, x, cfg, with_stats, **kw)
        return spy
    return wrap


def profiled_train_step(trainer, batch):
    """One more step of ``trainer`` on ``batch`` under torch.profiler, the
    optimizer under OPTIMIZER_RANGE; returns (profiler, wall ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with patched(trainer.tx, "update", in_range(OPTIMIZER_RANGE)), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        trainer.state, stats = trainer.step_fn(trainer.state, batch)
        float(stats["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    return prof, wall_ms


def profile_step(trainer, name: str = "chip_smoke_profile.json") -> dict:
    """One more step under torch.profiler: device time by kernel and by
    category, the optimizer's share (the kernels under its range), the idle
    share of the step's wall time; the table is written to
    chiprun_out/``name``."""
    from oim_tpu_torch.train.trainer import synthetic_batches

    batch = trainer.place_batch(next(synthetic_batches(trainer.cfg)))
    prof, wall_ms = profiled_train_step(trainer, batch)
    # Device-side events only (kernels, memcpy/memset): CPU-side ops carry
    # their children's device time too and would count it twice. The
    # optimizer's range is an annotation row, not a kernel.
    rows = sorted(((ev.key, ev.self_device_time_total / 1e3, ev.count)
                   for ev in prof.key_averages()
                   if str(ev.device_type).endswith("CUDA") and ev.self_device_time_total > 0
                   and ev.key != OPTIMIZER_RANGE),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    cats: dict[str, float] = {}
    for key, ms, _ in rows:
        cats[_category(key)] = cats.get(_category(key), 0.0) + ms
    optimizer_ms = device_ms_by_category(prof, (OPTIMIZER_RANGE,), (), "rest").get(
        OPTIMIZER_RANGE, 0.0)
    say(f"  profiled step: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms, "
        f"idle share {max(0.0, 1 - busy / wall_ms):.3f}; the optimizer's kernels "
        f"{optimizer_ms:.1f} ms ({optimizer_ms / busy:.1%}), forward and backward the rest")
    for cat, ms in sorted(cats.items(), key=lambda c: -c[1]):
        say(f"    {ms:9.3f} ms  {ms / busy:6.1%}  {cat}")
    for key, ms, count in rows[:12]:
        say(f"    {ms:9.3f} ms  x{count:<5d} {key[:100]}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    result = {"wall_ms": wall_ms, "busy_ms": busy, "optimizer_ms": optimizer_ms,
              "categories": cats, "rows": rows}
    (out / name).write_text(json.dumps(result, indent=1))
    return result


# -- observability read-backs (phases 5, 7, 8, 11, 12, 14) ------------------
#
# The port records the JAX package's metric families, flight-recorder events
# and spans (oim_tpu_torch/common/{metrics,events,tracing}.py). Each phase
# reads them back against what it saw itself; registries are process-wide,
# so every count is a delta between two reads.

_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$")
_LABEL = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def parse_metrics(text: str) -> dict:
    """Prometheus text -> {(name, ((label, value), ...)): value}; comment
    lines and OpenMetrics exemplar suffixes are skipped."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line.split(" # ", 1)[0])
        if m is None:
            fail(f"obs: unparsable /metrics line {line!r}")
        out[(m.group(1), tuple(sorted(_LABEL.findall(m.group(2) or ""))))] = float(m.group(3))
    return out


def sample(snap: dict, name: str, **labels) -> float:
    return snap.get((name, tuple(sorted((k, str(v)) for k, v in labels.items()))), 0.0)


def delta(after: dict, before: dict, name: str, **labels) -> float:
    return sample(after, name, **labels) - sample(before, name, **labels)


def label_deltas(after: dict, before: dict, name: str, label: str) -> dict:
    """{label value: delta} of one labeled family, nonzero deltas only."""
    out = {}
    for (n, labels), v in after.items():
        if n == name:
            d = v - before.get((n, labels), 0.0)
            if d:
                out[dict(labels)[label]] = d
    return out


def registry_now() -> dict:
    from oim_tpu_torch.common import metrics as M

    return parse_metrics(M.DEFAULT.render())


def scrape(port: int) -> dict:
    """One GET /metrics of the port's MetricsServer, parsed."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
        return parse_metrics(r.read().decode())


def settle(pred, what: str, timeout: float = 10.0) -> None:
    """A request's stream closes just before the engine counts its outcome
    (the JAX order): wait, bounded, for the engine thread's last counts."""
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            fail(f"obs: {what} not recorded within {timeout:.0f} s")
        time.sleep(0.01)


def quantile_bucket(after: dict, before: dict, name: str, q: float, **labels) -> tuple:
    """(bucket upper bounds, index of the bucket that holds the nearest-rank
    q-quantile of the observations made between two reads)."""
    want = {k: str(v) for k, v in labels.items()}
    rows = []
    for (n, lab), v in after.items():
        d = dict(lab)
        if n == name + "_bucket" and all(d.get(k) == v2 for k, v2 in want.items()):
            rows.append((float(d["le"]), v - before.get((n, lab), 0.0)))
    rows.sort()
    total = rows[-1][1]
    rank = min(total - 1, int(q * total)) + 1
    bounds = [le for le, _ in rows]
    return bounds, next(i for i, (_, cum) in enumerate(rows) if cum >= rank)


def check_train_gauges(hist: list, spans: list, steps: int, what: str) -> dict:
    """The trainer's gauges equal its last logged step, and one train.step
    span was recorded for each step."""
    from oim_tpu_torch.common import metrics as M

    last = hist[-1]
    got = {"step_s": M.TRAIN_STEP_SECONDS.value, "mfu": M.TRAIN_MFU.value,
           "feed_wait_s": M.FEED_WAIT_SECONDS.value}
    want = {k: last[k] for k in got}
    if "moe_drop_frac" in last:
        got["moe_drop_frac"], want["moe_drop_frac"] = M.MOE_DROP_FRAC.value, last["moe_drop_frac"]
    steps_seen = [s["args"]["step"] for s in spans if s["name"] == "train.step"]
    say(f"  obs: gauges {got}; train.step spans for steps {steps_seen}")
    if got != want:
        fail(f"{what}: the trainer's gauges {got} are not its last logged step's {want}")
    if steps_seen != list(range(1, steps + 1)):
        fail(f"{what}: train.step spans for steps {steps_seen}, want 1..{steps}")
    return {"gauges": got, "train_step_spans": len(steps_seen)}


class ServeObs:
    """Phases 7 and 12: the port's span recorder streaming to a file in a
    temporary directory (what ``--trace-dir`` does), a fresh flight
    recorder, a MetricsServer on 127.0.0.1 at port 0, and the registry as
    it stood before the burst."""

    def __init__(self, service: str):
        from oim_tpu_torch.common import events, tracing
        from oim_tpu_torch.common.metrics import MetricsServer

        self.service = service
        self.dir = tempfile.mkdtemp(prefix="oim-trace-")
        self.recorder = tracing.configure(service, trace_dir=self.dir)
        events.configure()
        self.server = MetricsServer(port=0, host="127.0.0.1").start()
        self.before = registry_now()

    def span_names(self) -> collections.Counter:
        from oim_tpu_torch.common import tracing

        self.recorder.flush()
        path = os.path.join(self.dir, f"{self.service}-{os.getpid()}.trace.json")
        return collections.Counter(e["name"] for e in tracing.load_trace_file(path)
                                   if e.get("ph") == "X")

    def close(self) -> None:
        from oim_tpu_torch.common import tracing

        self.server.stop()
        tracing.configure("chip-smoke")  # closes the file; later spans stay in the ring
        shutil.rmtree(self.dir, ignore_errors=True)


def check_burst(obs: ServeObs, reqs: list, what: str) -> tuple[dict, dict]:
    """After a burst: one scrape over HTTP, held against the handles. Each
    outcome counted as the handles ended, every token the handles received,
    one first-token latency for each request that emitted one. Returns the
    scrape and the read-backs."""
    from oim_tpu_torch.common import metrics as M

    outcomes = collections.Counter(r["handle"].finish_reason for r in reqs)
    settle(lambda: sum(label_deltas(registry_now(), obs.before, M.SERVE_REQUESTS_TOTAL.name,
                                    "outcome").values()) >= len(reqs),
           f"{what}: the burst's outcomes")
    after = scrape(obs.server.port)
    got = {
        "outcomes": label_deltas(after, obs.before, M.SERVE_REQUESTS_TOTAL.name, "outcome"),
        "tokens": delta(after, obs.before, M.SERVE_TOKENS_TOTAL.name),
        "first_tokens": delta(after, obs.before, M.SERVE_TOKEN_LATENCY.name + "_count",
                              kind="first"),
    }
    want = {"outcomes": {k: float(v) for k, v in outcomes.items()},
            "tokens": float(sum(len(r["out"]) for r in reqs)),
            "first_tokens": float(sum(1 for r in reqs if r["out"]))}
    say(f"  obs: /metrics scraped over HTTP after the burst: {got}")
    if got != want:
        fail(f"{what}: /metrics reads {got}, the handles saw {want}")
    return after, got


def check_phase_spans(obs: ServeObs, reqs: list, what: str) -> dict:
    """One serve.queue_wait span for each admitted request and one
    serve.decode span for each request with more than one token."""
    names = obs.span_names()
    got = {k: names[k] for k in ("serve.queue_wait", "serve.decode", "serve.prefill")}
    want = {"serve.queue_wait": len(reqs),
            "serve.decode": sum(1 for r in reqs if len(r["out"]) > 1),
            "serve.prefill": len(reqs)}
    say(f"  obs: span file {got}")
    if got != want:
        fail(f"{what}: the span file holds {got}, want {want}")
    return got


def check_decode_fault() -> dict:
    """serve.decode armed on a small engine on the card: the loop's
    catch-all fails every request and the engine admits nothing more."""
    import torch

    from oim_tpu_torch.common import faultinject
    from oim_tpu_torch.common import metrics as M
    from oim_tpu_torch.models import llama
    from oim_tpu_torch.serve import Draining, ServeEngine

    cfg = llama.tiny()
    params = llama.init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    eng = ServeEngine(params, cfg, device="cuda", max_batch=2, max_seq=64, name="faulty")
    before = registry_now()
    faultinject.arm("serve.decode", engine="faulty")
    try:
        handles = [eng.submit(list(range(1, 10 + i)), max_new=8) for i in range(3)]
        outs = [h.result(timeout=RESULT_TIMEOUT) for h in handles]
        reasons = [h.finish_reason for h in handles]
        try:
            eng.submit([1, 2, 3], max_new=2)
            after_fault = "admitted"
        except Draining:
            after_fault = "refused (Draining)"
    finally:
        faultinject.reset()
    eng.stop(quiet=True)
    errors = delta(registry_now(), before, M.SERVE_REQUESTS_TOTAL.name, outcome="error")
    say(f"  obs: serve.decode armed on llama.tiny on the card: {len(handles)} requests ended "
        f"{reasons} after {[len(o) for o in outs]} tokens; a later submit {after_fault}; "
        f"errors counted {errors:.0f}")
    if reasons != ["error"] * len(handles) or after_fault == "admitted" \
            or errors != len(handles) or eng.pool_stats()["used_pages"]:
        fail(f"serve.decode fault: requests ended {reasons}, a later submit {after_fault}, "
             f"{errors} errors counted")
    return {"reasons": reasons, "later_submit": after_fault}


class StageObs:
    """Phases 8 and 14: the stage-cache counters against the backends'
    ``StageCache.stats()``, the flight recorder's evictions and the stage
    seconds, from the phase's start; ``staged`` measures the
    oim_staged_bytes_total delta of one operation."""

    def __init__(self):
        from oim_tpu_torch.common import events

        self.before = registry_now()
        self.seq = max((e.seq for e in events.recorder().events()), default=0)
        self.backends = []

    @staticmethod
    def staged(fn):
        """(fn's result, the staged bytes it recorded)."""
        from oim_tpu_torch.common import metrics as M

        b0 = M.STAGED_BYTES.value
        out = fn()
        return out, M.STAGED_BYTES.value - b0

    def check(self, what: str) -> dict:
        from oim_tpu_torch.common import events
        from oim_tpu_torch.common import metrics as M

        after = registry_now()
        stats = [b.cache.stats() for b in self.backends]
        want = {k: float(sum(s[k] for s in stats)) for k in ("hits", "misses", "evictions")}
        got = {k: delta(after, self.before, f"oim_stage_cache_{k}_total") for k in want}
        evicted = sum(1 for e in events.recorder().events()
                      if e.seq > self.seq and e.type == events.STAGE_CACHE_EVICTION)
        seconds = delta(after, self.before, M.STAGE_SECONDS.name)
        say(f"  obs: stage cache counters {got} (StageCache.stats() {want}); "
            f"stage_cache_eviction events {evicted}; stage seconds {seconds:.3f}")
        if got != want or evicted != want["evictions"] or not seconds > 0:
            fail(f"{what}: stage-cache counters {got} against stats() {want}, {evicted} "
                 f"eviction events, stage seconds {seconds}")
        return {"cache_counters": got, "eviction_events": evicted, "stage_seconds": seconds}


def obs_costs(n: int = 200_000) -> dict:
    """The host cost of one Histogram.observe with an exemplar (the engine's
    per-token call, labels() included) and one events.emit, in microseconds,
    on a registry and a ring of their own."""
    from oim_tpu_torch.common import events
    from oim_tpu_torch.common import metrics as M

    h = M.Registry().histogram("cost_seconds", labelnames=("kind",),
                               buckets=M.SERVE_TOKEN_LATENCY.buckets)
    rec = events.EventRecorder()
    t0 = time.perf_counter()
    for i in range(n):
        h.labels(kind="next").observe(0.01, "a" * 32)
    observe_us = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    for i in range(n):
        rec.emit(events.SLOT_EVICTED, trace_id="", slot=0, reason="cancelled", tokens=i)
    emit_us = (time.perf_counter() - t0) / n * 1e6
    say(f"  obs: one Histogram.observe {observe_us:.3f} us, one events.emit {emit_us:.3f} us "
        f"(host clock, mean of {n})")
    return {"observe_us": observe_us, "emit_us": emit_us, "n": n}


# -- serving (phases 6-7) ------------------------------------------------

SERVE_TINY_TOL = 1e-4        # f32 logits, card against CPU, TF32 off
# bf16 first-decode logits of the paged batch against solo cached_forward,
# as max|diff| / max|logit|. Solo at batch 2 against batch 1 (the same
# dense path at another product shape) reads up to ~0.021 on the H100 and
# the paged batch up to ~0.019; a page, offset or mask fault reads O(1).
SERVE_LOGIT_REL = 2.0 ** -4
SERVE_LENGTHS = (17, 48, 64, 200, 333, 700, 1000, 1500)
SERVE_PREFIX, SERVE_TAILS = 512, (130, 7, 40, 95)
SERVE_CANCEL, SERVE_CANCEL_AFTER = "len700", 8
SERVE_ALONE, SERVE_PROMOTED = "prefix+130", "prefix+7"
PREFILL_BUCKETS = (64, 512, 1024, 2048)
SERVE_ENGINE = dict(max_batch=8, max_seq=2048, queue_depth=16, prefix_block=16,
                    prefix_cache_bytes=1 << 30, kv_host_bytes=1 << 30)
RESULT_TIMEOUT = 600.0


def pct(xs, q: float):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else None


def first_divergence(a, b) -> int:
    """How many leading tokens two streams share."""
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return n


def run_requests(eng, reqs):
    """Submit every request at once and collect the streams; fails on
    anything but a full-length finish."""
    handles = [eng.submit(p, max_new=n, temperature=t, seed=s) for p, n, t, s in reqs]
    outs = [h.result(timeout=RESULT_TIMEOUT) for h in handles]
    for (p, n, _, _), h, out in zip(reqs, handles, outs):
        if h.finish_reason != "length" or len(out) != n:
            fail(f"serving: request of {len(p)} tokens ended {h.finish_reason!r} after "
                 f"{len(out)} of {n} tokens; engine error: {eng.error}")
    return outs


def check_paged_steps(cfg, host, device, errors: list) -> None:
    """``prefill_into_pages`` (two rows), ``decode_step`` and
    ``verify_step`` logits of the weights ``host`` (numpy) on the card
    against the CPU, within SERVE_TINY_TOL."""
    import torch

    from oim_tpu_torch.models import generate as gen
    from oim_tpu_torch.models import llama

    page, g = 4, torch.Generator().manual_seed(1)
    tables = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]])
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g) for n in (9, 5)]
    cand = torch.randint(0, cfg.vocab, (2, 4), generator=g)
    pos = torch.tensor([9, 5])

    def steps(dev):
        p, pool = llama.from_numpy(host, dev), gen.init_page_pool(cfg, 9, page, device=dev)
        outs = []
        for row, prompt in enumerate(prompts):
            padded = torch.zeros(1, 16, dtype=torch.long)
            padded[0, :len(prompt)] = prompt
            outs.append(gen.prefill_into_pages(p, padded.to(dev), len(prompt), pool,
                                               tables[row].to(dev), 0, cfg, page)[0])
        outs.append(gen.decode_step(p, cand[:, 0].to(dev), pool, tables.to(dev),
                                    pos.to(dev), cfg, page)[0])
        outs.append(gen.verify_step(p, cand.to(dev), pool, tables.to(dev),
                                    (pos + 1).to(dev), cfg, page)[0])
        return [o.cpu() for o in outs]

    for name, a, b in zip(("prefill_into_pages row 0", "prefill_into_pages row 1",
                           "decode_step", "verify_step"), steps(device), steps("cpu")):
        check(name, a, b, SERVE_TINY_TOL, errors)


def phase_serve_agreement(device="cuda"):
    """Phase 6: llama.tiny (f32) through the serving path on the card
    against the CPU and against itself."""
    import torch

    from oim_tpu_torch.models import generate as gen
    from oim_tpu_torch.models import llama
    from oim_tpu_torch.serve import ServeEngine, kvtier

    cfg = llama.tiny(vocab=64, dim=32, n_layers=2)
    host = llama.to_numpy(llama.init(torch.Generator().manual_seed(0), cfg, device="cpu"))
    errors = []
    check_paged_steps(cfg, host, device, errors)
    if errors:
        fail("serving steps on the card disagree with the CPU: " + "; ".join(errors))

    params = llama.from_numpy(host, device)
    rs = np.random.RandomState(3)
    shared = rs.randint(0, cfg.vocab, 8).tolist()
    reqs = [(rs.randint(0, cfg.vocab, n).tolist(), 12, 0.0, i)
            for i, n in enumerate((3, 17, 1, 30))]
    reqs += [(shared + [i], 10, 0.0, 9) for i in range(3)]
    engine_kw = dict(max_batch=4, max_seq=64, prefix_block=4, device=device)

    def run(eng):
        # The shared-prefix requests one at a time: the 2nd and 3rd hit.
        return run_requests(eng, reqs[:4]) + [run_requests(eng, [r])[0] for r in reqs[4:]]

    eng = ServeEngine(params, cfg, **engine_kw)
    plain = run(eng)
    hits = eng.request_stats()["prefix_hits"]
    eng.stop()
    solo = [gen.generate(params, torch.tensor([p], device=device), n, cfg,
                         max_seq=64)[0, len(p):].tolist() for p, n, _, _ in reqs]
    eng = ServeEngine(params, cfg, draft_params=params, draft_cfg=cfg, spec_tokens=3,
                      **engine_kw)
    spec = run(eng)
    spec_stats = eng.stats()
    eng.stop()
    # Tensor-parallel serving, two members sharing the card (f32, TF32
    # off: the members' summed partials round as the whole product does).
    sharded = {}
    for name, kw in (("plain", {}), ("spec", dict(draft_params=params, draft_cfg=cfg,
                                                    spec_tokens=3))):
        eng = ServeEngine(params, cfg, shard=2, devices=list(SHARD_DEVICES), **kw,
                          **engine_kw)
        sharded[name] = run(eng)
        eng.stop()
    say(f"  engine greedy streams equal to solo generate() on the card: "
        f"{sum(a == b for a, b in zip(plain, solo))}/{len(reqs)}  (prefix hits {hits})")
    say(f"  self-draft spec engine greedy streams equal to the plain engine's: "
        f"{sum(a == b for a, b in zip(spec, plain))}/{len(reqs)}  "
        f"(accepted {spec_stats['spec_accepted']} of {spec_stats['spec_proposed']})")
    say(f"  shard 2 on {list(SHARD_DEVICES)}: plain and spec greedy streams equal to "
        f"shard 1's: {sum(a == b for a, b in zip(sharded['plain'], plain))}/{len(reqs)}, "
        f"{sum(a == b for a, b in zip(sharded['spec'], plain))}/{len(reqs)}")
    if plain != solo or hits != 2:
        fail(f"serving: engine greedy streams differ from solo generate() or the prefix "
             f"store missed ({hits} hits, want 2): {plain} vs {solo}")
    if spec != plain or not spec_stats["spec_accepted"]:
        fail(f"serving: spec streams differ from plain or accepted nothing: {spec} vs {plain}")
    if sharded["plain"] != plain or sharded["spec"] != plain:
        fail(f"serving: shard-2 greedy streams differ from shard 1's: {sharded} vs {plain}")

    gb = torch.Generator(device=device).manual_seed(2)
    pool = {n: torch.randn(2, 6, 16, 8, 128, generator=gb, device=device).to(torch.bfloat16)
            for n in ("k", "v")}
    before = {n: t[:, 3].cpu().view(torch.int16) for n, t in pool.items()}
    k, v = kvtier.page_kv(pool, 3)
    kvtier.stage_page(pool, 5, k, v)
    exact = (k.tobytes() == before["k"].numpy().tobytes()
             and v.tobytes() == before["v"].numpy().tobytes()
             and all(torch.equal(pool[n][:, 5].cpu().view(torch.int16), before[n])
                     for n in ("k", "v")))
    say(f"  host tier: bf16 page demoted (pinned D2H) and promoted (pinned H2D): "
        f"{'bit-exact' if exact else 'DIFFERS'}")
    if not exact:
        fail("serving: the host-tier round trip changed a page's bytes")


def serve_traffic(vocab: int, seed: int = 0) -> list[dict]:
    """The main path's 12 requests: 8 prompts of SERVE_LENGTHS tokens and 4
    sharing one SERVE_PREFIX-token prefix; every other one sampled."""
    rs = np.random.RandomState(seed)
    reqs = [{"name": f"len{n}", "prompt": rs.randint(0, vocab, n).tolist(),
             "max_new": 128 if n == 1500 else 64,
             "temperature": 0.0 if i % 2 == 0 else 0.8, "seed": 100 + i}
            for i, n in enumerate(SERVE_LENGTHS)]
    prefix = rs.randint(0, vocab, SERVE_PREFIX).tolist()
    reqs += [{"name": f"prefix+{t}", "prompt": prefix + rs.randint(0, vocab, t).tolist(),
              "max_new": 64, "temperature": 0.8 if j in (0, 3) else 0.0, "seed": 200 + j,
              "shared": True}
             for j, t in enumerate(SERVE_TAILS)]
    return reqs


def _submit(eng, r):
    return eng.submit(r["prompt"], max_new=r["max_new"], temperature=r["temperature"],
                      seed=r["seed"])


def phase_serve_main(cfg, params, device="cuda", profile=False) -> dict:
    """Phase 7: the engine at the cell's width and depth, then the
    measurements, then speculation."""
    import gc
    import threading

    import torch

    from oim_tpu_torch import kernels
    from oim_tpu_torch.models import generate as gen
    from oim_tpu_torch.serve import ServeEngine

    from oim_tpu_torch.common import metrics as M

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    obs = ServeObs("chip-smoke-serve")
    eng = ServeEngine(params, cfg, device=device, **SERVE_ENGINE)
    reqs = serve_traffic(cfg.vocab)
    by = {r["name"]: r for r in reqs}
    t0 = time.monotonic()
    alone = by[SERVE_ALONE]
    alone["handle"] = _submit(eng, alone)
    alone["out"] = alone["handle"].result(timeout=RESULT_TIMEOUT)
    rest = [r for r in reqs if r is not alone]
    for r in rest:
        r["handle"] = _submit(eng, r)

    def cancel_after(r):
        out = []
        for tok in r["handle"].tokens(timeout=RESULT_TIMEOUT):
            out.append(tok)
            if len(out) == SERVE_CANCEL_AFTER:
                r["handle"].cancel()
        r["out"] = out

    watcher = threading.Thread(target=cancel_after, args=(by[SERVE_CANCEL],))
    watcher.start()
    for r in rest:
        if r["name"] != SERVE_CANCEL:
            r["out"] = r["handle"].result(timeout=RESULT_TIMEOUT)
    watcher.join(RESULT_TIMEOUT)
    wall = time.monotonic() - t0
    stats = {**eng.stats(), **eng.request_stats()}
    if eng.error:
        fail(f"serving: the engine thread died:\n{eng.error}")
    for r in reqs:
        h, want = r["handle"], ("cancelled" if r["name"] == SERVE_CANCEL else "length")
        ok = h.finish_reason == want and (want == "cancelled" or len(r["out"]) == r["max_new"])
        say(f"  {r['name']:<11s} prompt {len(r['prompt']):5d}  "
            f"{'sampled t=0.8' if r['temperature'] else 'greedy       '}  "
            f"{len(r['out']):3d}/{r['max_new']} tokens  {h.finish_reason:<9s}  "
            f"prefix {h.stats['prefix_tokens']:4d}  first token "
            f"{h.stats['first_token_s'] * 1e3:8.1f} ms")
        if not ok:
            fail(f"serving: {r['name']} ended {h.finish_reason!r} with {len(r['out'])} "
                 f"tokens, want {want!r} with {r['max_new']}")
    say(f"  prefix hits {stats['prefix_hits']}, prefill tokens from the store "
        f"{stats['prefill_tokens_cached']}, computed {stats['prefill_tokens_computed']}; "
        f"{stats['decode_tokens']} decode tokens in {stats['target_steps']} steps, "
        f"wall {wall:.2f} s")
    n_hits = len(SERVE_TAILS) - 1
    if (stats["prefix_hits"], stats["prefill_tokens_cached"]) != (n_hits, n_hits * SERVE_PREFIX):
        fail(f"serving: want {n_hits} prefix hits saving {n_hits * SERVE_PREFIX} tokens, got "
             f"{stats['prefix_hits']} and {stats['prefill_tokens_cached']}")
    scraped, obs_out = check_burst(obs, reqs, "serving")
    prefix = {"hits": delta(scraped, obs.before, M.SERVE_PREFIX_HITS.name),
              "cache_tokens": delta(scraped, obs.before, M.SERVE_PREFILL_TOKENS.name,
                                    source="cache")}
    say(f"  obs: prefix hits {prefix['hits']:.0f}, prefill tokens from the store "
        f"{prefix['cache_tokens']:.0f}")
    if prefix != {"hits": n_hits, "cache_tokens": n_hits * SERVE_PREFIX}:
        fail(f"serving: /metrics reads {prefix}, want {n_hits} hits of {SERVE_PREFIX} tokens")
    host_gaps = [g for r in reqs for g in r["handle"].stats["inter_token_s"]]
    obs_out["inter_token"] = {}
    for q in (0.5, 0.99):
        bounds, i = quantile_bucket(scraped, obs.before, M.SERVE_TOKEN_LATENCY.name, q,
                                    kind="next")
        host = pct(host_gaps, q)
        j = bisect.bisect_left(bounds, host)
        say(f"  obs: inter-token p{q * 100:.0f}: histogram bucket le={bounds[i]} (bucket "
            f"{i}), host clock {host * 1e3:.2f} ms (bucket {j}), over {len(host_gaps)} gaps")
        if abs(i - j) > 1:
            fail(f"serving: the inter-token p{q * 100:.0f} histogram bucket {i} and the host "
                 f"clock's bucket {j} differ by more than one")
        obs_out["inter_token"][f"p{q * 100:.0f}"] = {
            "histogram_le_s": bounds[i], "host_s": host}
    obs_out["prefix"] = prefix

    freed = eng.evict_prefix_store()  # the engine is idle: every request ended
    host = eng.host_stats()
    again = by[SERVE_PROMOTED]
    h = _submit(eng, again)
    out = h.result(timeout=RESULT_TIMEOUT)
    host_after = eng.host_stats()
    promoted = host_after["promotions"] - host["promotions"]
    say(f"  host tier: evicting the store freed {freed} pages into {host['entries']} host "
        f"blocks ({host['bytes'] / 2**20:.0f} MiB); {SERVE_PROMOTED} again: {promoted} "
        f"blocks promoted, prefix {h.stats['prefix_tokens']} tokens, first token "
        f"{h.stats['first_token_s'] * 1e3:.1f} ms, stream "
        f"{'equal to' if out == again['out'] else 'DIFFERENT from'} its first run")
    if (out != again["out"] or h.stats["prefix_tokens"] != SERVE_PREFIX
            or promoted < SERVE_PREFIX // SERVE_ENGINE["prefix_block"]):
        fail("serving: the request promoted from the host tier did not repeat its first run")
    now = registry_now()
    tier = {k: delta(now, obs.before, f"oim_kvtier_{k}_total")
            for k in ("demotions", "promotions")}
    say(f"  obs: host-tier counters {tier}, host_stats() {host_after}")
    if tier != {k: float(host_after[k]) for k in tier}:
        fail(f"serving: host-tier counters {tier} against host_stats() {host_after}")
    eng.stop(drain=True)
    eng.evict_prefix_store()
    eng.evict_host_tier()
    used = eng.pool_stats()["used_pages"]
    say(f"  after drain and eviction: {used} pages used (gauge "
        f"{M.SERVE_KV_PAGES_USED.value:.0f})")
    if used or M.SERVE_KV_PAGES_USED.value:
        fail(f"serving: {used} pages leaked past drain and eviction (gauge "
             f"{M.SERVE_KV_PAGES_USED.value})")
    obs_out["tier"] = tier
    obs_out["spans"] = check_phase_spans(obs, reqs + [{"out": out}], "serving")
    obs.close()
    obs_out["decode_fault"] = check_decode_fault()

    # One burst of 12 requests is a functional smoke, not a load: its
    # percentiles (a few samples, queue order decides them) are smoke
    # readings, kept apart from the measurements and not for comparison.
    misses = [r["handle"].stats["first_token_s"] * 1e3 for r in rest if not r.get("shared")]
    hits = [r["handle"].stats["first_token_s"] * 1e3 for r in rest if r.get("shared")]
    gaps = [g * 1e3 for r in reqs for g in r["handle"].stats["inter_token_s"]]
    result = {
        "model": "llama3-8b" if cfg.dim == 4096 else f"dim {cfg.dim}",
        "layers": cfg.n_layers, "requests": len(reqs), "engine": SERVE_ENGINE, "obs": obs_out,
        "wall_s": wall, "prefix_hits": stats["prefix_hits"],
        "prefill_tokens_cached": stats["prefill_tokens_cached"],
        "decode_tokens": stats["decode_tokens"], "target_steps": stats["target_steps"],
        "first_token_alone_ms": {
            "miss": alone["handle"].stats["first_token_s"] * 1e3,
            "host_promoted_hit": h.stats["first_token_s"] * 1e3},
        "burst_smoke_not_for_comparison": {
            "first_token_miss_p50_ms": pct(misses, 0.5), "n_miss": len(misses),
            "first_token_hit_p50_ms": pct(hits, 0.5), "n_hit": len(hits),
            "inter_token_p50_ms": pct(gaps, 0.5), "inter_token_p99_ms": pct(gaps, 0.99),
            "n_gaps": len(gaps)},
    }
    smoke = result["burst_smoke_not_for_comparison"]
    say(f"  first token, one request on an idle engine: miss ({len(alone['prompt'])} tokens) "
        f"{result['first_token_alone_ms']['miss']:.1f} ms, host-tier hit "
        f"{result['first_token_alone_ms']['host_promoted_hit']:.1f} ms")
    say(f"  burst smoke readings (12 requests at once; not a load measurement): first "
        f"token miss p50 {smoke['first_token_miss_p50_ms']:.1f} ms over {len(misses)}, "
        f"hit p50 {smoke['first_token_hit_p50_ms']:.1f} ms over {len(hits)} (queue wait "
        f"included); inter-token p50 {smoke['inter_token_p50_ms']:.2f} ms, p99 "
        f"{smoke['inter_token_p99_ms']:.2f} ms over {len(gaps)} gaps")
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    result.update(serve_measure(cfg, params, reqs, device, profile))
    # The streams of this run, for the shard-2 replay (not printed).
    result["_streams"] = {r["name"]: r["out"] for r in reqs}

    spec_names = [r["name"] for r in reqs if not r["temperature"] and not r.get("shared")]
    eng = ServeEngine(params, cfg, device=device, max_batch=8, max_seq=2048, queue_depth=16,
                      draft_params=params, draft_cfg=cfg, spec_tokens=4)
    outs = run_requests(eng, [(by[n]["prompt"], by[n]["max_new"], 0.0, 0) for n in spec_names])
    st = {**eng.stats(), **eng.request_stats()}
    eng.stop()
    # Tokens a live row gains per target forward: 1 for plain decode.
    tpts = st["decode_tokens"] / max(st["decode_row_steps"], 1)
    same = [first_divergence(o, by[n]["out"]) for n, o in zip(spec_names, outs)]
    say(f"  speculation (self-draft, spec_tokens 4, {len(spec_names)} greedy requests): "
        f"acceptance {st['spec_accept_rate']}, {tpts:.2f} tokens per row per target step "
        f"({st['decode_tokens']} tokens in {st['target_steps']} steps, "
        f"{st['decode_row_steps']} row-steps); tokens equal to the plain engine's before "
        f"the first divergence: {same}")
    if not (st["spec_accept_rate"] or 0) > 0 or not tpts > 1:
        fail(f"serving: speculation accepted nothing ({st})")
    result["spec"] = {"accept_rate": st["spec_accept_rate"], "tokens_per_target_step": tpts,
                      "equal_to_plain_prefix": same}
    del eng
    gc.collect()
    result["kernel_launches"] = dict(kernels.LAUNCHES)
    result["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    say(f"  peak memory {result['peak_mem_gb']:.1f} GB; kernel launches on the "
        f"serving path {result['kernel_launches']} (no kernel of the port is on it)")
    return result


def serve_measure(cfg, params, reqs, device, profile, moe_inputs: list | None = None,
                  profile_name: str = "chip_smoke_serve_profile.json") -> dict:
    """Solo generate() against the engine's greedy streams; an 8-row paged
    batch (the 8 prompts of SERVE_LENGTHS): first-decode logits against
    solo, the decode step's time and bound, solo prefill by bucket, and
    (``profile``) one profiled decode step. ``moe_inputs`` (a list) takes
    the batch's first decode step's ``moe_calls``."""
    import contextlib

    import torch

    from oim_tpu_torch.models import generate as gen
    from oim_tpu_torch.models import moe
    from oim_tpu_torch.train.state import tree_leaves

    agree = {}
    for r in reqs:
        if r["temperature"] == 0 and r["name"] != SERVE_CANCEL:
            solo = gen.generate(params, torch.tensor([r["prompt"]], device=device),
                                r["max_new"], cfg)[0, len(r["prompt"]):].tolist()
            agree[r["name"]] = first_divergence(solo, r["out"])
    say(f"  greedy tokens equal to solo generate() before the first divergence: {agree} "
        f"(reported: bf16 products at other shapes round differently)")

    page, rows = SERVE_ENGINE["prefix_block"], [r for r in reqs if not r.get("shared")]
    n_blocks = SERVE_ENGINE["max_seq"] // page
    pool = gen.init_page_pool(cfg, len(rows) * n_blocks + 1, page, device=device)
    tables = torch.zeros(len(rows), n_blocks, dtype=torch.long)
    firsts = []
    for b, r in enumerate(rows):
        n = len(r["prompt"])
        tables[b, :-(-(n + 1) // page)] = torch.arange(-(-(n + 1) // page)) + 1 + b * n_blocks
        padded = torch.zeros(1, max(8, 1 << (n - 1).bit_length()), dtype=torch.long)
        padded[0, :n] = torch.tensor(r["prompt"])
        last, _ = gen.prefill_into_pages(params, padded.to(device), n, pool,
                                         tables[b].to(device), 0, cfg, page)
        firsts.append(int(last.argmax()))
    tables = tables.to(device)
    tokens = torch.tensor(firsts, device=device)
    pos = torch.tensor([len(r["prompt"]) for r in rows], device=device)
    with (contextlib.nullcontext() if moe_inputs is None
          else patched(moe, "apply", moe_calls(moe_inputs))):
        logits, _ = gen.decode_step(params, tokens, pool, tables, pos, cfg, page)
    errs, floor = {}, {}

    def solo_decode(prompt, tok, batch):
        n = len(prompt)
        cache = gen.init_cache(cfg, batch, n + 1, device=device)
        gen.cached_forward(params, torch.tensor([prompt] * batch, device=device), cache,
                           0, cfg)
        return gen.cached_forward(params, tok.expand(batch, 1), cache, n, cfg)[0][0, -1]

    for b, r in enumerate(rows):
        want = solo_decode(r["prompt"], tokens[b:b + 1, None], 1)
        # The noise floor: the same dense path with the prompt twice in
        # the batch (other product shapes, so other bf16 roundings).
        twin = solo_decode(r["prompt"], tokens[b:b + 1, None], 2)
        errs[r["name"]] = float((logits[b] - want).abs().max() / want.abs().max())
        floor[r["name"]] = float((twin - want).abs().max() / want.abs().max())
    say(f"  first decode step, 8 paged rows against solo cached_forward: max|diff| / "
        f"max|logit| {({k: round(v, 5) for k, v in errs.items()})} (limit "
        f"{SERVE_LOGIT_REL:.4f}); solo at batch 2 against batch 1, the same "
        f"measure: {({k: round(v, 5) for k, v in floor.items()})}")
    bad = {k: v for k, v in errs.items() if not v <= SERVE_LOGIT_REL}
    if bad:
        fail(f"serving: the paged batch's first-decode logits differ from solo "
             f"cached_forward beyond {SERVE_LOGIT_REL} x max|logit|: {bad}")

    temps = torch.tensor([r["temperature"] for r in rows], device=device)
    uniforms = torch.full((len(rows),), 0.5, device=device)

    def step():
        return gen.sample(gen.decode_step(params, tokens, pool, tables, pos, cfg, page)[0],
                          temps, uniforms)

    step_ms = cuda_ms(step, 10)
    # The bytes the step must read: every weight but the embedding table,
    # of which the lookup reads one row per token, and the K/V the rows'
    # positions hold (with the one each writes).
    embed = params["embed"]
    weight_bytes = (sum(t.numel() * t.element_size() for t in tree_leaves(params))
                    - embed.numel() * embed.element_size()
                    + len(rows) * cfg.dim * embed.element_size())
    kv_bytes = int(sum(int(p) + 1 for p in pos) * 2 * cfg.n_layers * cfg.kv_dim
                   * cfg.dtype.itemsize)
    bound = (weight_bytes + kv_bytes) / PEAK_HBM_BYTES * 1e3
    say(f"  decode step, 8 rows at {[int(p) for p in pos]} (mean context "
        f"{float(pos.float().mean()):.0f}): {step_ms:.2f} ms, "
        f"{len(rows) / step_ms * 1e3:.0f} tokens/s; bound {bound:.2f} ms (bytes: "
        f"{weight_bytes / 1e9:.3f} GB of weights read (8 embedding rows) + "
        f"{kv_bytes / 1e9:.3f} GB K/V at 3.35e12 B/s), {step_ms / bound:.1f}x the bound")
    profiled = profile_decode(step, profile_name) if profile else None
    prefill = {}
    for T in PREFILL_BUCKETS:
        toks = torch.randint(0, cfg.vocab, (1, T), device=device)
        table = tables[0].clone()
        table[:T // page] = torch.arange(T // page, device=device) + 1
        prefill[T] = cuda_ms(lambda: gen.prefill_into_pages(
            params, toks, T, pool, table, 0, cfg, page), 3)
    say("  solo prefill: " + ", ".join(f"{T} tokens {ms:.1f} ms ({T / ms * 1e3:.0f} tokens/s)"
                                       for T, ms in prefill.items()))
    out = {"greedy_equal_prefix": agree, "first_decode_logit_rel_err": errs,
           "first_decode_logit_rel_err_batch2_solo": floor,
           "decode_step_ms": step_ms, "decode_tokens_per_s": len(rows) / step_ms * 1e3,
           "decode_bound_ms": bound, "decode_positions": [int(p) for p in pos],
           "prefill_ms": prefill}
    if profiled is not None:
        out["profile"] = profiled
        # The profiled window's wall carries the profiler's host work; the
        # same busy time over the step's CUDA-event time is the idle share
        # of an unprofiled step.
        out["decode_idle_share"] = max(0.0, 1 - profiled["busy_ms"] / step_ms)
        say(f"  decode step idle share without the profiler: device busy "
            f"{profiled['busy_ms']:.2f} of {step_ms:.2f} ms -> {out['decode_idle_share']:.3f}; "
            f"{step_ms * 1e3 / max(profiled['aten_ops'], 1):.1f} us of step per aten op")
    return out


SHARD_DEVICES = ("cuda:0", "cuda:0")  # two members on the one card


def replay_streams(eng, reqs) -> dict:
    """Phase 7's submission order on ``eng``: SERVE_ALONE alone (it leaves
    the shared prefix in the store), then the rest at once; each request's
    stream by name. Every request must end by length."""
    by = {r["name"]: r for r in reqs}
    first = by[SERVE_ALONE]
    out = {first["name"]: _submit(eng, first).result(timeout=RESULT_TIMEOUT)}
    handles = {r["name"]: _submit(eng, r) for r in reqs if r is not first}
    for name, h in handles.items():
        out[name] = h.result(timeout=RESULT_TIMEOUT)
        if h.finish_reason != "length":
            fail(f"sharded serving: {name} ended {h.finish_reason!r}; engine error: "
                 f"{eng.error}")
    return out


def decode_step_ms(cfg, params, reqs, device, group=None) -> float:
    """One 8-row paged decode step (serve_measure's batch: the prompts of
    SERVE_LENGTHS after their prefill) timed by CUDA events, through the
    engine's target forwards: one device (``group`` None) or the members of
    ``group``, whose params and pools are then the members'."""
    import torch

    from oim_tpu_torch.models import generate as gen
    from oim_tpu_torch.serve import engine as E
    from oim_tpu_torch.serve import shard as S

    page, rows = SERVE_ENGINE["prefix_block"], [r for r in reqs if not r.get("shared")]
    n_blocks = SERVE_ENGINE["max_seq"] // page
    n_pages = len(rows) * n_blocks + 1
    decode, prefill, _ = E.target_forwards(cfg, page, group)
    if group is None:
        pool = gen.init_page_pool(cfg, n_pages, page, device=device)
    else:
        lcfg = gen.shard_config(cfg, group.size)
        params = [S.member_params(params, group.size, k, d) for k, d in enumerate(group.devices)]
        pool = [gen.init_page_pool(lcfg, n_pages, page, device=d) for d in group.devices]
    tables = torch.zeros(len(rows), n_blocks, dtype=torch.long)
    firsts = []
    for b, r in enumerate(rows):
        n = len(r["prompt"])
        tables[b, :-(-(n + 1) // page)] = torch.arange(-(-(n + 1) // page)) + 1 + b * n_blocks
        padded = torch.zeros(1, max(8, 1 << (n - 1).bit_length()), dtype=torch.long)
        padded[0, :n] = torch.tensor(r["prompt"])
        last, _ = prefill(params, padded.to(device), n, pool, tables[b].to(device), 0)
        firsts.append(int(last.argmax()))
    tables = tables.to(device)
    tokens = torch.tensor(firsts, device=device)
    pos = torch.tensor([len(r["prompt"]) for r in rows], device=device)
    with torch.inference_mode():
        ms = cuda_ms(lambda: decode(params, tokens, pool, tables, pos), 10)
    del params, pool
    return ms


def phase_serve_sharded(cfg, params, streams: dict, device="cuda",
                        devices=SHARD_DEVICES) -> dict:
    """Phase 7's tensor-parallel half: the member-memory gate refuses the
    model at shard 1 and admits it at shard 2; ``ServeEngine(shard=2,
    devices=devices)`` at full width and depth, each member holding
    ``member_weight_bytes``; phase 7's requests replayed in its order, each
    ending by length, their agreement with ``streams`` (phase 7's, shard 1)
    reported; one allreduce observation per target dispatch; shard 1's
    greedy streams teacher-forced through both (``teacher_forced``); then
    the 8-row decode step at shard 1 and shard 2, a reading beside each
    other."""
    import gc

    import torch

    from oim_tpu_torch.common import metrics as M
    from oim_tpu_torch.serve import ServeEngine
    from oim_tpu_torch.serve import shard as S

    t0 = time.monotonic()
    # The budget: exactly what a member needs at shard 2 (half the split
    # weights, the replicated ones, half the pool), which one device
    # holding everything exceeds.
    pool_bytes = (SERVE_ENGINE["max_batch"] * SERVE_ENGINE["max_seq"] * 2 * cfg.n_layers
                  * cfg.kv_dim * cfg.dtype.itemsize)
    budget = S.check_member_budget(params, 2, pool_bytes, 0)
    try:
        ServeEngine(params, cfg, device=device, member_hbm_budget=budget, **SERVE_ENGINE)
    except ValueError as e:
        refused = str(e)
    else:
        fail("sharded serving: shard=1 was admitted past a member budget of the weights alone")
    say(f"  member budget {budget} B (a member's need at shard 2): shard 1 refused "
        f"({refused})")
    torch.cuda.reset_peak_memory_stats()
    ici = M.SERVE_ICI_ALLREDUCE.count
    eng = ServeEngine(params, cfg, device=device, shard=2, devices=list(devices),
                      member_hbm_budget=budget, **SERVE_ENGINE)
    want_bytes = S.member_weight_bytes(params, 2)
    held = [sum(t.numel() * t.element_size() for t in _leaf_tensors(p)) for p in eng.params]
    say(f"  shard 2 on {list(devices)} admitted; weight bytes by member {held} "
        f"(member_weight_bytes {want_bytes}; the full tree {S.member_weight_bytes(params, 1)})")
    if held != [want_bytes] * 2:
        fail(f"sharded serving: members hold {held} B of weights, want {want_bytes} each")
    reqs = serve_traffic(cfg.vocab)
    t_run = time.monotonic()
    got = replay_streams(eng, reqs)
    wall = time.monotonic() - t_run
    stats = eng.stats()
    observed = M.SERVE_ICI_ALLREDUCE.count - ici
    eng.stop(drain=True)
    if eng.error:
        fail(f"sharded serving: the engine thread died:\n{eng.error}")
    greedy = [r["name"] for r in reqs if r["temperature"] == 0]
    same = {n: first_divergence(got[n], streams[n]) for n in greedy}
    sampled = {r["name"]: first_divergence(got[r["name"]], streams[r["name"]])
               for r in reqs if r["temperature"] and r["name"] != SERVE_CANCEL}
    say(f"  shard 2: {stats['decode_tokens']} decode tokens in {stats['target_steps']} target "
        f"steps, wall {wall:.2f} s; tokens equal to shard 1's before the first divergence "
        f"(reported: at bf16 the sharded products round differently from the whole ones, "
        f"as other shapes do against solo above): greedy {same} (of "
        f"{[len(streams[n]) for n in greedy]}), sampled {sampled}; allreduce "
        f"observations {observed}")
    if observed != stats["target_steps"]:
        fail(f"sharded serving: {observed} allreduce observations for "
             f"{stats['target_steps']} target dispatches")
    peak = torch.cuda.max_memory_allocated() / 1e9
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    group = S.member_group(S.member_devices(2, list(devices)))
    forced = teacher_forced(cfg, params, {r["name"]: r["prompt"] for r in reqs
                                          if r["temperature"] == 0}, streams, device, group)
    one = decode_step_ms(cfg, params, reqs, device)
    two = decode_step_ms(cfg, params, reqs, device, group)
    allreduce_ms = 1e3 * min(S.time_allreduce(group) for _ in range(5))
    # The members' meetings of one decode step alone: two a layer, on the
    # 8 rows' [8, dim] f32 partials.
    parts = [torch.zeros(8, cfg.dim, device=d) for d in group.devices]

    def meet(k):
        for _ in range(2 * cfg.n_layers):
            group.allreduce(parts[k])
        torch.cuda.synchronize(group.devices[k])

    group.run(meet)
    t_meet = time.perf_counter()
    group.run(meet)
    rendezvous_ms = (time.perf_counter() - t_meet) * 1e3
    gc.collect()
    torch.cuda.empty_cache()
    say(f"  8-row decode step (a reading, not a claim): shard 1 {one:.2f} ms, shard 2 "
        f"{two:.2f} ms on {list(devices)}, of which the {2 * cfg.n_layers} rendezvous "
        f"alone take {rendezvous_ms:.2f} ms (host clock); one 1 KiB allreduce "
        f"{allreduce_ms:.3f} ms; peak memory {peak:.1f} GB; phase "
        f"{time.monotonic() - t0:.1f} s")
    return {"devices": list(devices), "refused_at_shard1": refused,
            "member_weight_bytes": want_bytes, "held_bytes_by_member": held,
            "greedy_equal_prefix": same, "sampled_equal_prefix": sampled,
            "teacher_forced": forced,
            "target_steps": stats["target_steps"], "allreduce_observations": observed,
            "wall_s": wall, "decode_step_ms": {"shard1": one, "shard2": two},
            "allreduce_1kib_ms": allreduce_ms, "rendezvous_ms_a_step": rendezvous_ms,
            "peak_mem_gb": peak,
            "note": ("two members sharing one card: a check of the sharded path, "
                     "not a multi-GPU speed" if len(set(devices)) == 1
                     else "members on distinct cards")}


def teacher_forced(cfg, params, prompts: dict, streams: dict, device, group) -> dict:
    """Each greedy stream of shard 1 (``streams``) after its prompt, fed
    through the engine's own target forwards (``target_forwards``) on one
    device and on the members of ``group``, each with its page pool (the
    members': their KV-head slices) behind one page table: the prompt's
    paged prefill, a decode step on the stream's first token, then one
    verify of the rest. The logits at every generated position must lie
    within SERVE_LOGIT_REL x max|logit| of one device's (a head, page or
    sum fault reads O(1)); the share of positions whose argmax agrees is
    reported."""
    import torch

    from oim_tpu_torch.models import generate as gen
    from oim_tpu_torch.serve import engine as E
    from oim_tpu_torch.serve import shard as S

    page = SERVE_ENGINE["prefix_block"]
    n_pages = SERVE_ENGINE["max_seq"] // page + 1
    lcfg = gen.shard_config(cfg, group.size)
    members = [S.member_params(params, group.size, k, d) for k, d in enumerate(group.devices)]
    runs = ((None, params, lambda: gen.init_page_pool(cfg, n_pages, page, device=device)),
            (group, members, lambda: [gen.init_page_pool(lcfg, n_pages, page, device=d)
                                      for d in group.devices]))
    table = torch.arange(1, n_pages, device=device)
    errs, agree = {}, {}
    for name, prompt in prompts.items():
        stream, n = streams[name], len(prompt)
        padded = torch.zeros(1, max(8, 1 << (n - 1).bit_length()), dtype=torch.long)
        padded[0, :n] = torch.tensor(prompt)
        padded = padded.to(device)
        logits = []
        for g, p, new_pool in runs:
            decode, prefill, verify = E.target_forwards(cfg, page, g)
            pool = new_pool()
            with torch.inference_mode():
                last, _ = prefill(p, padded, n, pool, table, 0)
                step, _ = decode(p, torch.tensor(stream[:1], device=device), pool, table[None],
                                 torch.tensor([n], device=device))
                rest, _ = verify(p, torch.tensor([stream[1:-1]], device=device), pool,
                                 table[None], torch.tensor([n + 1], device=device))
            logits.append(torch.cat([last[None].to(device), step.to(device),
                                     rest[0].to(device)]))
            del pool
        one, two = logits
        errs[name] = float((two - one).abs().max() / one.abs().max())
        agree[name] = float((two.argmax(-1) == one.argmax(-1)).float().mean())
        del one, two, logits
    del members
    say(f"  teacher-forced through the paged target forwards (prefill, decode, verify), "
        f"shard 1's greedy streams at shard 2: max|diff| / max|logit| at the generated "
        f"positions {({k: round(v, 5) for k, v in errs.items()})} (limit "
        f"{SERVE_LOGIT_REL:.4f}); argmax agreement "
        f"{({k: round(v, 4) for k, v in agree.items()})}")
    bad = {k: v for k, v in errs.items() if not v <= SERVE_LOGIT_REL}
    if bad:
        fail(f"sharded serving: shard 2's logits on shard 1's streams differ beyond "
             f"{SERVE_LOGIT_REL} x max|logit|: {bad}")
    return {"logit_rel_err": errs, "argmax_agreement": agree}


def _leaf_tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaf_tensors(v)
    else:
        yield tree


SERVE_CATEGORIES = (
    ("matmuls (projections, lm_head)", ("aten::mm", "aten::addmm")),
    ("page-table gather and copies", ("aten::index", "aten::index_put_",
                                      "aten::_index_put_impl_", "aten::copy_",
                                      "aten::clone", "aten::contiguous")),
    ("cache attention (scores, mask, softmax, PV)", ("aten::bmm", "aten::_softmax",
                                                     "aten::masked_fill_",
                                                     "aten::masked_fill")),
)


def device_ms_by_category(prof, ranges, categories, default) -> dict[str, float]:
    """Device ms of every kernel, charged to the host op that launched it:
    to the innermost enclosing ``record_function`` range named in
    ``ranges``, else to the first category listing the op's name, else to
    ``default``."""
    cats: dict[str, float] = {}
    for ev in prof.events():
        ms = getattr(ev, "self_device_time_total", 0) / 1e3
        if str(ev.device_type).endswith("CUDA") or ms <= 0:
            continue
        p = ev
        while p is not None and p.name not in ranges:
            p = p.cpu_parent
        cat = p.name if p is not None else next(
            (c for c, ops in categories if ev.name in ops), default)
        cats[cat] = cats.get(cat, 0.0) + ms
    return cats


MOE_RANGE = "MoE FFN (router, dispatch, experts, combine)"


def profile_decode(step, name: str = "chip_smoke_serve_profile.json") -> dict:
    """One 8-row decode step (with sampling) under torch.profiler: device ms
    by category, each kernel charged to the op that launched it (sampling
    and an MoE model's FFN: everything under their ranges), and the idle
    share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from oim_tpu_torch.models import generate as gen
    from oim_tpu_torch.models import moe

    torch.cuda.synchronize()
    with patched(gen, "sample", in_range("sampling")), \
            patched(moe, "apply", in_range(MOE_RANGE)), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step().cpu()
        wall_ms = (time.monotonic() - t0) * 1e3
    # The ranges show on the device timeline too, as annotation rows: not
    # kernels, so left out of the busy time.
    kernels_ = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
                for ev in prof.key_averages()
                if str(ev.device_type).endswith("CUDA") and ev.self_device_time_total > 0
                and ev.key not in ("sampling", MOE_RANGE)]
    busy = sum(k[1] for k in kernels_)
    cats = device_ms_by_category(prof, ("sampling", MOE_RANGE), SERVE_CATEGORIES,
                                 "elementwise and other")
    attributed = sum(cats.values())
    if busy > attributed + 1e-3:
        cats["not attributed to an op"] = busy - attributed
    idle = max(0.0, 1 - busy / wall_ms) if wall_ms else None
    launches = sum(k[2] for k in kernels_)
    ops = sum(1 for ev in prof.events()
              if ev.cpu_parent is None and ev.name.startswith("aten::"))
    say(f"  profiled decode step: wall {wall_ms:.2f} ms (the profiler's own host work "
        f"included), device busy {busy:.2f} ms, idle share {idle:.3f}; {launches} kernel "
        f"launches from {ops} top-level aten ops")
    for cat, ms in sorted(cats.items(), key=lambda c: -c[1]):
        say(f"    {ms:9.3f} ms  {ms / max(busy, 1e-9):6.1%}  {cat}")
    for key, ms, count in sorted(kernels_, key=lambda k: -k[1])[:12]:
        say(f"    {ms:9.3f} ms  x{count:<5d} {key[:100]}")
    result = {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": idle,
              "kernel_launches": launches, "aten_ops": ops,
              "categories": cats, "kernels": kernels_}
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / name).write_text(json.dumps(result, indent=1))
    return result


# -- OIM-fed training (phase 8) ------------------------------------------

FED_TOKENS = 1 << 30          # int32 tokens: a 4 GiB, ~1 B-token pretraining shard
FED_CHUNK = 64 << 20          # the backend's staging chunk
FED_CACHE = 8 << 30           # stage-cache capacity (the 1 GiB default would skip it)
FED_BLOCK = 1 << 26           # tokens per block written and compared (256 MiB)
FED_CANCEL_AT = 1 << 30       # landed bytes at which phase 8 unstages a stage


def write_token_volume(path: str, n_tokens: int, vocab: int, seed: int = 0) -> None:
    """An int32 .npy of n_tokens in [0, vocab) from a seeded generator,
    written block by block and synced to the disk, so that no writeback of
    its pages runs beside the reads timed after it (they stay cached)."""
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<i4", "fortran_order": False, "shape": (n_tokens,)})
        for a in range(0, n_tokens, FED_BLOCK):
            rng.integers(0, vocab, min(FED_BLOCK, n_tokens - a), dtype=np.int32).tofile(f)
        f.flush()
        os.fsync(f.fileno())


def check_volume_bytes(arr, path: str) -> None:
    """The staged tensor against the file, block by block on the card."""
    import torch

    mm = np.load(path, mmap_mode="r")
    if tuple(arr.shape) != mm.shape or arr.dtype != torch.int32:
        fail(f"oim-fed: staged {tuple(arr.shape)} {arr.dtype}, the file holds "
             f"{mm.shape} {mm.dtype}")
    for a in range(0, mm.shape[0], FED_BLOCK):
        want = torch.from_numpy(np.array(mm[a:a + FED_BLOCK])).to(arr.device)
        got = arr[a:a + FED_BLOCK]
        if not torch.equal(got, want):
            first = a + int((got != want).nonzero()[0, 0])
            fail(f"oim-fed: staged token {first} is {int(arr[first])}, the file has "
                 f"{int(mm[first])}")


def h2d_gbps() -> float:
    """One pinned FED_CHUNK copy to the card, by CUDA events: the H2D half
    of a stage timed alone."""
    import torch

    pinned = torch.empty(FED_CHUNK, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(FED_CHUNK, dtype=torch.uint8, device="cuda")
    ms = cuda_ms(lambda: dev.copy_(pinned, non_blocking=True), 20, warmup=2)
    return FED_CHUNK / (ms * 1e-3) / 1e9


def _same_bytes(a: np.ndarray, b: np.ndarray) -> bool:
    if a.size % 8 == 0 and a.ctypes.data % 8 == 0 and b.ctypes.data % 8 == 0:
        a, b = a.view(np.uint64), b.view(np.uint64)
    return bool(np.array_equal(a, b))


def time_read_engines(path: str, payload: int, nbytes: int) -> tuple[dict, dict]:
    """The read half of a stage timed alone, by engine: ``nbytes`` of
    ``path`` from ``payload`` on, read in FED_CHUNK pieces into one
    torch-pinned FED_CHUNK buffer (host clock around each read only), in
    two rounds, the second in the reverse order of the first, so that no
    engine always reads first. Each piece is compared with the file after
    its read, untimed. An engine this host refuses is recorded as
    "unavailable: <reason>", never timed under another's name. Returns
    GB/s by engine (the mean of the rounds, or the reason) and each
    round's GB/s by engine."""
    import torch

    from oim_tpu_torch.common import metrics as M
    from oim_tpu_torch.data import staging

    buf = torch.empty(FED_CHUNK, dtype=torch.uint8, pin_memory=True).numpy()
    mm = np.memmap(path, np.uint8, mode="r")
    engines, out = [], {}
    for engine in staging.ENGINES:
        if engine == "io_uring" and not staging.io_uring_available():
            out[engine] = f"unavailable: {staging.io_uring_error()}"
            say(f"  read engine io_uring {out[engine]}")
        else:
            engines.append(engine)
    rounds: dict = {engine: [] for engine in engines}
    for order in (engines, engines[::-1]):
        for engine in order:
            read_s = 0.0
            staged0 = M.STAGED_BYTES.value
            for off in range(0, nbytes, FED_CHUNK):
                n = min(FED_CHUNK, nbytes - off)
                t0 = time.monotonic()
                staging.read_into(path, buf[:n], offset=payload + off, engine=engine)
                read_s += time.monotonic() - t0
                if staging.read_path() != engine:
                    fail(f"read engines: asked for {engine}, {staging.read_path()} ran")
                if not _same_bytes(buf[:n], mm[payload + off:payload + off + n]):
                    fail(f"read engines: {engine} read other bytes than the file at {off}")
            if M.STAGED_BYTES.value - staged0 != nbytes:
                fail(f"read engines: {engine} read {nbytes} bytes, oim_staged_bytes_total "
                     f"rose by {M.STAGED_BYTES.value - staged0}")
            rounds[engine].append(nbytes / read_s / 1e9)
    del mm
    for engine in engines:
        out[engine] = sum(rounds[engine]) / len(rounds[engine])
    return {e: out[e] for e in staging.ENGINES}, rounds


def check_stage_after_queued_work(path: str, nbytes: int) -> dict:
    """Stage two chunks of the volume into a block that was freed while
    kernels queued on the current stream still wrote it: the caching
    allocator hands such a block straight back on the same stream, so the
    copies land correctly only if the copy stream waits on that stream.

    Two things synchronise the host with the device and would hide the
    hazard, so both are done once first: a page-locked allocation (a
    first stage of the same bytes fills the host cache, as a stage beside
    a running trainer finds it) and the first launch of a kernel (CUDA
    loads modules lazily: the first ``fill_`` would wait out the queued
    work before the copies are enqueued)."""
    import torch

    from oim_tpu_torch.data import plane

    n = 2 * FED_CHUNK
    payload = os.path.getsize(path) - nbytes
    src = plane.ExtentSource([plane.Extent("file", path, payload, n)])
    want = torch.from_numpy(np.fromfile(path, np.uint8, count=n, offset=payload)).cuda()
    warm = plane.stage_source(src, dtype=torch.uint8, shape=(n,), device="cuda",
                              chunk_bytes=FED_CHUNK)
    del warm
    torch.cuda.synchronize()
    block = torch.empty(n, dtype=torch.uint8, device="cuda")
    ptr = block.data_ptr()
    block.fill_(0xAB)
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)  # ~0.5 s of queued work on the current stream
    block.fill_(0xAB)                 # then a write to the block...
    del block                         # ...freed while both are still queued
    arr = plane.stage_source(src, dtype=torch.uint8, shape=(n,), device="cuda",
                             chunk_bytes=FED_CHUNK)
    reused = arr.data_ptr() == ptr
    torch.cuda.synchronize()
    equal = torch.equal(arr, want)
    say(f"  stage into a block freed under queued work: block reused {reused}, staged "
        f"bytes equal to the file {equal}")
    if not reused:
        fail("oim-fed: the allocator did not hand the freed block to the stage, so the "
             "queued-work check did not reach its case")
    if not equal:
        fail("oim-fed: a stage into a block freed under queued work lost its bytes to "
             "that work (the copy stream did not wait on the current stream)")
    return {"queued_work_block_reused": reused, "queued_work_bytes_equal": equal}


def train_on_tokens(tokens, what: str, others: dict, feed=None,
                    feed_note: str = "") -> dict:
    """Phase 5's trainer (llama3-8b width, LAYERS layers, B=BATCH, T=SEQ)
    for STEPS steps on ``volume_token_batches`` of a token tensor on the
    card (or on ``feed``, described by ``feed_note``), with phase 5's
    checks: every loss finite, the first near ln(vocab), K1-K3 at LAYERS x
    STEPS launches each, all on ``wgmma``. ``others`` holds other paths'
    step_s by name, printed beside and returned with the run's own."""
    import torch

    from oim_tpu_torch import kernels
    from oim_tpu_torch.data.feeds import volume_token_batches
    from oim_tpu_torch.models import llama
    from oim_tpu_torch.train import TrainConfig, Trainer

    vocab = llama.LLAMA3_8B.vocab
    cfg = TrainConfig(model="llama3-8b", model_overrides={"n_layers": LAYERS},
                      batch_size=BATCH, seq_len=SEQ, warmup_steps=2, total_steps=STEPS,
                      log_every=1)
    trainer = Trainer(cfg, device="cuda")
    trainer.init()
    if feed is None:
        feed = volume_token_batches(tokens, cfg)
        feed_note = f"a gather of {BATCH} x {SEQ + 1} int32 on the card"
    kernels.reset_launches()
    t0 = time.monotonic()
    trainer.run(steps=STEPS, data=feed)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(kernels.LAUNCHES)
    routes = {name: dict(r) for name, r in kernels.ROUTES.items()}
    hist = trainer.history
    losses = [r["loss"] for r in hist]
    steady = hist[1:] if len(hist) > 1 else hist
    step_s = sum(r["step_s"] for r in steady) / len(steady)
    mfu = sum(r["mfu"] for r in steady) / len(steady)
    feed_wait = sum(r["feed_wait_s"] for r in steady) / len(steady)
    say(f"  losses {losses}")
    say(f"  launches {launches}, routes {routes}  (want {LAYERS} x {STEPS} each, all wgmma)")
    say(f"  step_s {step_s:.4f} (steps 2..{STEPS}), MFU {mfu:.4f}; "
        + "; ".join(f"{k} {v:.4f}" for k, v in others.items())
        + f"; feed wait {feed_wait * 1e3:.3f} ms a step ({feed_note}); wall {wall:.1f} s")
    if len(losses) != STEPS or not all(math.isfinite(x) for x in losses):
        fail(f"{what}: losses not finite or missing: {losses}")
    if abs(losses[0] - math.log(vocab)) > 1.0:
        fail(f"{what}: first loss {losses[0]} not near ln(vocab) {math.log(vocab):.3f}")
    for name, _ in KERNELS:
        if launches[name] != LAYERS * STEPS or routes[name]["wgmma"] != LAYERS * STEPS:
            fail(f"{what}: {name} launched {launches[name]} times ({routes[name]}), want "
                 f"{LAYERS * STEPS} on wgmma")
    return {"launches": launches, "routes": routes, "losses": losses, "step_s": step_s,
            "mfu": mfu, "feed_wait_s": feed_wait, **others}


# ReadVolume's byte window on the card (phase 8): the windows read and
# compared, the timed windows, and the windowed feed's window, a multiple
# of neither the 8,196-byte record nor the 16,392-byte batch.
WINDOW = 64 << 20
WINDOW_ODD = (WINDOW - 3, 7_013)        # cuts an element and a staging chunk's edge
WINDOW_TAIL = (1 << 20) + 3             # the volume's last bytes, through length=0
WINDOW_TIMED = 16                       # 64 MiB windows timed: 1 GiB
WINDOW_BF16 = 64 << 20                  # the bfloat16 volume's bytes
FEED_WINDOW = 24_000
WINDOW_RSS_LIMIT = 512 << 20            # host growth allowed over the timed windows


def d2h_gbps() -> float:
    """One WINDOW copy from the card into page-locked memory, by CUDA
    events: the D2H yardstick beside the windows' rate."""
    import torch

    pinned = torch.empty(WINDOW, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(WINDOW, dtype=torch.uint8, device="cuda")
    ms = cuda_ms(lambda: pinned.copy_(dev, non_blocking=True), 20, warmup=2)
    return WINDOW / (ms * 1e-3) / 1e9


def host_rss() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def check_window_bytes(arr, file_bytes: np.ndarray, what: str) -> list:
    """ReadVolume's windows of a staged tensor (``read_window``) against the
    file's bytes: the first WINDOW, an odd window cutting an element and a
    chunk edge, and the last WINDOW_TAIL bytes through ``length=0``."""
    from oim_tpu_torch.controller.backend import read_window

    total = file_bytes.size
    reads = [(0, WINDOW), WINDOW_ODD, (total - WINDOW_TAIL, 0)]
    for offset, length in reads:
        got, n = read_window(arr, offset, length)
        end = total if length == 0 else min(offset + length, total)
        if n != total or not _same_bytes(got, file_bytes[offset:end]):
            fail(f"oim-fed windows: {what} window ({offset}, {length}) is not the file's "
                 f"bytes [{offset}, {end}) (total {n} against {total})")
    say(f"  {what}: windows {reads} equal to the file's bytes")
    return reads


def phase_windows(arr, path: str, sobs, expect_staged, tmp: str) -> dict:
    """ReadVolume's byte window (``controller.backend.read_window``, the
    function ReadVolume and a local Feeder call) on the card: windows of
    the int32 volume and of a bfloat16 volume against the files' bytes;
    WINDOW_TIMED windows timed by the host clock beside a pinned D2H
    yardstick; the device and host memory a window run takes."""
    import gc

    import torch

    from oim_tpu_torch.controller import CUDABackend, StagedVolume, StageState
    from oim_tpu_torch.controller.backend import read_window
    from oim_tpu_torch.spec import ArraySpec, FileParams

    nbytes = arr.numel() * arr.element_size()
    mm = np.load(path, mmap_mode="r")
    out = {"int32_windows": check_window_bytes(arr, mm.view(np.uint8), "int32 volume")}
    del mm

    bf_path = os.path.join(tmp, "bf16.raw")
    np.random.default_rng(1).integers(0, 1 << 16, WINDOW_BF16 // 2,
                                      dtype=np.uint16).tofile(bf_path)
    bf_backend = CUDABackend(chunk_bytes=FED_CHUNK, keep_cached=False)
    sobs.backends.append(bf_backend)
    bvol = StagedVolume("oim-fed-bf16", b"", ArraySpec(dtype="bfloat16"))

    def stage_bf16():
        bf_backend.stage(bvol, "file", FileParams(bf_path, "raw"))
        bvol.wait()

    _, got = sobs.staged(stage_bf16)
    expect_staged("bfloat16 window volume", got, WINDOW_BF16)
    if bvol.state != StageState.READY or bvol.array.dtype != torch.bfloat16:
        fail(f"oim-fed windows: the bfloat16 volume ended {bvol.state} "
             f"{getattr(bvol.array, 'dtype', None)}: {bvol.error}")
    out["bf16_windows"] = check_window_bytes(bvol.array, np.fromfile(bf_path, np.uint8),
                                             "bfloat16 volume")
    bf_backend.unstage(bvol)
    del bvol
    gc.collect()

    read_window(arr, 0, WINDOW)  # first-use costs out of the timing
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dev0, rss0 = torch.cuda.memory_allocated(), host_rss()
    rss_peak = rss0
    t0 = time.monotonic()
    for i in range(WINDOW_TIMED):
        w, _ = read_window(arr, (i * WINDOW) % nbytes, WINDOW)
        if w.size != WINDOW:
            fail(f"oim-fed windows: window {i} gave {w.size} bytes, not {WINDOW}")
        rss_peak = max(rss_peak, host_rss())
        del w
    seconds = time.monotonic() - t0
    dev_growth = torch.cuda.max_memory_allocated() - dev0
    rss_growth = rss_peak - rss0
    out.update(window_bytes=WINDOW, windows_timed=WINDOW_TIMED, window_s=seconds,
               window_gbps=WINDOW_TIMED * WINDOW / seconds / 1e9, d2h_gbps=d2h_gbps(),
               device_growth_bytes=dev_growth, host_rss_growth_bytes=rss_growth)
    say(f"  {WINDOW_TIMED} windows of {WINDOW >> 20} MiB ({WINDOW_TIMED * WINDOW >> 20} MiB, "
        f"host clock): {seconds:.3f} s, {out['window_gbps']:.2f} GB/s; yardstick, same run: "
        f"pinned {WINDOW >> 20} MiB D2H {out['d2h_gbps']:.2f} GB/s (CUDA events)")
    say(f"  memory over the windows: device peak growth {dev_growth} bytes, host RSS peak "
        f"growth {rss_growth} bytes (volume {nbytes}; limits 0 and {WINDOW_RSS_LIMIT})")
    if dev_growth > 0 or rss_growth > WINDOW_RSS_LIMIT:
        fail(f"oim-fed windows: a window run grew device memory by {dev_growth} bytes and "
             f"host RSS by {rss_growth}: a window must move only its own bytes")
    return out


def windowed_token_feed(arr):
    """Phase 8's batches through the windowed feed (``windowed_batches``
    over ``read_window`` of the staged tensor, FEED_WINDOW bytes at a
    time): host int32 [BATCH, SEQ + 1] batches, the trainer uploads
    them."""
    from oim_tpu_torch.controller.backend import read_window
    from oim_tpu_torch.data.feeds import windowed_batches

    rec = (SEQ + 1) * 4
    for raw in windowed_batches(lambda off, n: read_window(arr, off, n), FEED_WINDOW,
                                rec, BATCH * rec):
        yield {"tokens": raw.view(np.int32).reshape(BATCH, -1).astype(np.int32)}


def phase_oim_fed(synthetic_step_s: float) -> dict:
    """Phase 8: a token volume staged from disk through CUDABackend, checked,
    restaged from the cache, cancelled and freed, then fed to the trainer."""
    import gc
    import shutil
    import tempfile

    import torch

    from oim_tpu_torch.controller import CUDABackend, StagedVolume, StageState
    from oim_tpu_torch.data import plane, staging
    from oim_tpu_torch.models import llama
    from oim_tpu_torch.spec import ArraySpec, FileParams

    vocab = llama.LLAMA3_8B.vocab
    nbytes = FED_TOKENS * 4
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base_alloc = torch.cuda.memory_allocated()
    out: dict = {"tokens": FED_TOKENS, "volume_bytes": nbytes, "chunk_bytes": FED_CHUNK,
                 "host_copy": "direct: page-locked reader buffer -> device"}
    sobs = StageObs()
    staged: dict = {}

    def expect_staged(name: str, got: float, want: int) -> None:
        staged[name] = got
        if got != want:
            fail(f"oim-fed: {name} staged {want} bytes, oim_staged_bytes_total rose by {got}")

    def run_stage(backend, volume_id: str, params) -> tuple:
        vol = StagedVolume(volume_id, b"", ArraySpec())
        t0 = time.monotonic()
        backend.stage(vol, "file", params)
        vol.wait()
        return vol, time.monotonic() - t0

    with tempfile.TemporaryDirectory(prefix="oim-fed-") as tmp:
        free = shutil.disk_usage(tmp).free
        if free < nbytes + (1 << 30):
            fail(f"oim-fed: the temp disk at {tmp} has {free / 2**30:.1f} GiB free, the "
                 f"volume needs {nbytes / 2**30:.0f} GiB (+1): cut FED_TOKENS")
        path = os.path.join(tmp, "tokens.npy")
        t0 = time.monotonic()
        write_token_volume(path, FED_TOKENS, vocab)
        out["write_s"] = time.monotonic() - t0
        say(f"  wrote {FED_TOKENS} int32 tokens in [0, {vocab}) ({nbytes / 2**30:.0f} GiB .npy) "
            f"in {out['write_s']:.1f} s; {free / 2**30:.0f} GiB were free")
        res, got = sobs.staged(lambda: check_stage_after_queued_work(path, nbytes))
        out.update(res)
        expect_staged("plane, two 2-chunk stages", got, 4 * FED_CHUNK)

        # -- cold stage --
        params = FileParams(path, "npy")
        backend = CUDABackend(cache_bytes=FED_CACHE, chunk_bytes=FED_CHUNK)
        sobs.backends.append(backend)
        calls = plane.STAGE_CALLS
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.max_memory_allocated()
        (vol, stage_s), got = sobs.staged(lambda: run_stage(backend, "oim-fed", params))
        expect_staged("cold stage (native)", got, nbytes)
        if vol.state != StageState.READY:
            fail(f"oim-fed: the cold stage ended {vol.state}: {vol.error}")
        growth = torch.cuda.max_memory_allocated() - before
        out.update(stage_s=stage_s, stage_gbps=nbytes / stage_s / 1e9,
                   breakdown=dict(plane.LAST_STAGE_BREAKDOWN), read_path=staging.read_path(),
                   stage_peak_model_bytes=plane.LAST_STAGE_PEAK, device_growth_bytes=growth,
                   plane_calls=plane.STAGE_CALLS - calls)
        bd = out["breakdown"]
        say(f"  cold stage: {stage_s:.3f} s, {out['stage_gbps']:.2f} GB/s; breakdown disk_s "
            f"{bd['disk_s']:.3f} (a page-cache read: the file was just written; "
            f"{out['read_path']}), h2d_s {bd['h2d_s']:.3f}, dispatch_s {bd['dispatch_s']:.3f}")
        if out["read_path"] != "native":
            fail(f"oim-fed: the cold stage read through {out['read_path']}, not the native "
                 "engine built in phase 2")
        say(f"  device bytes: plane model {out['stage_peak_model_bytes']}, growth of "
            f"max_memory_allocated {growth} (volume {nbytes}, limit volume + 2 chunks)")
        if growth > nbytes + 2 * FED_CHUNK or out["plane_calls"] != 1:
            fail(f"oim-fed: device growth {growth} > volume + 2 chunks, or "
                 f"{out['plane_calls']} plane calls for one stage")
        engines, rounds = time_read_engines(path, os.path.getsize(path) - nbytes, nbytes)
        timed = {k: v for k, v in engines.items() if isinstance(v, float)}
        fastest = max(timed, key=timed.get)
        yard = {"h2d_gbps": h2d_gbps(), "read_gbps": timed[fastest],
                "read_gbps_by_engine": engines, "read_gbps_rounds": rounds,
                "read_engine_fastest": fastest}
        halves = (nbytes / (yard["read_gbps"] * 1e9), nbytes / (yard["h2d_gbps"] * 1e9))
        out.update(yard, bound_s=max(halves), faster_half_s=min(halves),
                   stage_over_bound=stage_s / max(halves))
        say(f"  yardsticks, same run: pinned {FED_CHUNK >> 20} MiB H2D {yard['h2d_gbps']:.2f} "
            f"GB/s (CUDA events); the file read alone into a pinned {FED_CHUNK >> 20} MiB "
            "buffer, by engine, mean of two rounds in turned order (all from a warm page "
            "cache: the file was just written; a cold disk is not measured): " + ", ".join(
                f"{k} {v:.2f} GB/s ({', '.join(f'{r:.2f}' for r in rounds[k])})"
                if isinstance(v, float) else f"{k} {v}"
                for k, v in engines.items()) + f"; fastest {fastest}")
        say(f"  stage bound {out['bound_s']:.3f} s (the slower half, the fastest engine's read "
            f"or H2D, alone; "
            f"the faster half takes {out['faster_half_s']:.3f} s): stage / bound "
            f"{out['stage_over_bound']:.2f}")

        # -- bytes --
        t0 = time.monotonic()
        check_volume_bytes(vol.array, path)
        say(f"  staged tensor equal to the file, byte for byte ({time.monotonic() - t0:.1f} s)")

        # -- cache hit --
        ptr = vol.array.data_ptr()
        backend.unstage(vol)
        calls = plane.STAGE_CALLS
        (hit, out["cache_hit_s"]), got = sobs.staged(lambda: run_stage(backend, "oim-fed",
                                                                        params))
        expect_staged("cache hit", got, 0)
        same = hit.array is not None and hit.array.data_ptr() == ptr
        say(f"  restage after unstage: {out['cache_hit_s'] * 1e3:.2f} ms, plane calls "
            f"{plane.STAGE_CALLS - calls}, same storage {same}")
        if hit.state != StageState.READY or plane.STAGE_CALLS != calls or not same:
            fail("oim-fed: the restage was not served from the stage cache")
        backend.unstage(hit)

        # -- cancel, then free --
        other = CUDABackend(cache_bytes=FED_CACHE, chunk_bytes=FED_CHUNK, keep_cached=False)
        sobs.backends.append(other)
        cvol = StagedVolume("oim-fed-2", b"", ArraySpec())
        other.stage(cvol, "file", params)
        while cvol.state == StageState.STAGING and cvol.bytes_staged < FED_CANCEL_AT:
            time.sleep(0.0005)
        out["cancel_at_bytes"] = cvol.bytes_staged
        other.unstage(cvol)
        cvol.wait()
        if cvol.state != StageState.FAILED or cvol.error != "unmapped during staging":
            fail(f"oim-fed: a stage unstaged at {out['cancel_at_bytes']} bytes ended "
                 f"{cvol.state} {cvol.error!r}")
        freed = backend.cache.evict_idle()
        gc.collect()
        after = torch.cuda.memory_allocated()
        say(f"  unstaged at {out['cancel_at_bytes']} landed bytes: FAILED "
            f"{cvol.error!r}; evicting the cache freed {freed} bytes; memory_allocated "
            f"{after} against {base_alloc} before the phase")
        if after != base_alloc:
            fail(f"oim-fed: {after - base_alloc} device bytes held after unstage, cancel "
                 f"and eviction")

        # -- train on the volume --
        (vol, out["restage_s"]), got = sobs.staged(lambda: run_stage(backend, "oim-fed",
                                                                      params))
        expect_staged("restage after eviction", got, nbytes)
        if vol.state != StageState.READY:
            fail(f"oim-fed: the restage ended {vol.state}: {vol.error}")
        say("  ReadVolume's byte window on the card (read_window; nothing over gRPC runs "
            "here: the card machine has no grpcio)")
        out["windows"] = phase_windows(vol.array, path, sobs, expect_staged, tmp)
    out.update(train_on_tokens(vol.array, "oim-fed", {"synthetic_step_s": synthetic_step_s}))
    say(f"  the windowed feed: {FEED_WINDOW}-byte windows (records of {(SEQ + 1) * 4} B, "
        f"batches of {BATCH * (SEQ + 1) * 4} B straddle them), the same tokens")
    win = train_on_tokens(
        vol.array, "oim-fed windowed", {"synthetic_step_s": synthetic_step_s,
                                        "oim_fed_step_s": out["step_s"]},
        feed=windowed_token_feed(vol.array),
        feed_note=f"{FEED_WINDOW}-byte windows off the card, records rebuilt on the host "
                  "and uploaded")
    same = win["losses"] == out["losses"]
    say(f"  windowed feed losses equal to phase 8's in-place losses, bit for bit: {same}; "
        f"feed wait {win['feed_wait_s'] * 1e3:.3f} ms a step against "
        f"{out['feed_wait_s'] * 1e3:.3f}; step_s {win['step_s']:.4f} against "
        f"{out['step_s']:.4f}")
    if not same:
        fail(f"oim-fed windowed: losses {win['losses']} differ from phase 8's in-place "
             f"{out['losses']}")
    out["windowed_feed"] = {"window_bytes": FEED_WINDOW, **win}
    backend.unstage(vol)
    backend.cache.evict_idle()
    out["obs"] = {"staged_bytes": staged, **sobs.check("oim-fed")}
    say(f"  obs: staged bytes by operation {staged}")
    del vol
    gc.collect()
    torch.cuda.empty_cache()
    return out

# -- OIM-fed ResNet-50 (phase 9) ------------------------------------------

# bench.py's OIM-fed cell (bench.py:333-342, :426-500): 1024 uint8 images
# of 224x224x3 staged as one volume, batch 128 sliced from it in place,
# 1000 classes, bf16. Nothing is cut.
RESNET_IMAGES, RESNET_SIZE, RESNET_BATCH, RESNET_CLASSES = 1024, 224, 128, 1000
RESNET_STEPS, RESNET_CKPT_EVERY = 8, 4
# Resumed and remat losses against the first run's, relative: the same
# bf16 arithmetic, but cuDNN's weight-gradient kernels may sum in another
# order from call to call.
RESNET_REL_TOL = 1e-3
# The remat step's bf16 gradients against the plain step's, the worst
# leaf's relative L2 (one bf16 rounding step is 2^-8 = 3.9e-3 of a value;
# a block whose backward went wrong reads of order 1).
RESNET_GRAD_TOL = 1e-2

RESNET_CATEGORIES = (
    ("convolution (cuDNN)", ("aten::cudnn_convolution", "aten::convolution_backward",
                             "aten::_convolution", "aten::convolution")),
    ("pooling, head and loss", ("aten::max_pool2d_with_indices",
                                "aten::max_pool2d_with_indices_backward", "aten::mean",
                                "aten::mm", "aten::addmm", "aten::logsumexp",
                                "aten::gather", "aten::scatter", "aten::scatter_add")),
)


def clone_state(state):
    """A deep copy of a TrainState on its device, params requiring grad."""
    from oim_tpu_torch.train.state import OptState, TrainState, tree_leaves

    def c(tree):
        if isinstance(tree, dict):
            return {k: c(v) for k, v in tree.items()}
        return tree.detach().clone()

    params = c(state.params)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    opt = state.opt_state
    return TrainState(step=state.step, params=params, extra=c(state.extra),
                      opt_state=OptState(count=opt.count, mu=c(opt.mu), nu=c(opt.nu)))


def state_differences(a, b) -> list[str]:
    """Where two TrainStates differ in any byte (dtype, shape and strides
    included), the steps and the optimizer's count too."""
    import torch

    from oim_tpu_torch.train.state import tree_leaves

    diffs = [n for n, x, y in (("step", a.step, b.step),
                               ("count", a.opt_state.count, b.opt_state.count)) if x != y]
    for name, x, y in (("params", a.params, b.params), ("extra", a.extra, b.extra),
                       ("mu", a.opt_state.mu, b.opt_state.mu),
                       ("nu", a.opt_state.nu, b.opt_state.nu)):
        xs, ys = list(tree_leaves(x)), list(tree_leaves(y))
        if len(xs) != len(ys):
            diffs.append(f"{name}: {len(xs)} leaves against {len(ys)}")
            continue
        for i, (s, t) in enumerate(zip(xs, ys)):
            t = t.to(s.device)
            if (s.dtype, s.shape, s.stride()) != (t.dtype, t.shape, t.stride()) or \
                    not torch.equal(s.detach().contiguous().reshape(-1).view(torch.uint8),
                                    t.detach().contiguous().reshape(-1).view(torch.uint8)):
                diffs.append(f"{name} leaf {i}")
    return diffs


def phase_resnet(llama_main: dict, profile: bool) -> dict:
    """Phase 9: bench.py's OIM-fed ResNet-50 through the port's Trainer:
    stage, train with checkpoints, evaluate, resume, remat; then phase 5's
    llama with remat."""
    import dataclasses
    import gc
    import itertools
    import shutil
    import tempfile

    import torch

    from oim_tpu_torch import kernels
    from oim_tpu_torch.cli import oim_trainer
    from oim_tpu_torch.controller import CUDABackend, StagedVolume, StageState
    from oim_tpu_torch.data.feeds import SeekableFeed
    from oim_tpu_torch.models import resnet
    from oim_tpu_torch.spec import ArraySpec, FileParams
    from oim_tpu_torch.train import TrainConfig, Trainer
    from oim_tpu_torch.train.checkpoint import STATE_FILE, Checkpointer
    from oim_tpu_torch.train.state import tree_leaves
    from oim_tpu_torch.train.trainer import flops_per_step

    n, size, batch = RESNET_IMAGES, RESNET_SIZE, RESNET_BATCH
    shape = (n, size, size, 3)
    out: dict = {"model": "resnet50", "images": n, "image_size": size, "batch": batch,
                 "classes": RESNET_CLASSES, "dtype": "bfloat16",
                 "params": resnet.num_params(resnet.Config())}
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="oim-resnet-") as tmp:
        # -- stage the volume --
        path = os.path.join(tmp, "images.raw")
        host = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
        with open(path, "wb") as f:
            host.tofile(f)
            f.flush()
            os.fsync(f.fileno())
        backend = CUDABackend()
        vol = StagedVolume("resnet-images", b"", ArraySpec(shape, "uint8"))
        t0 = time.monotonic()
        backend.stage(vol, "file", FileParams(path, "raw"))
        vol.wait()
        out["stage_s"] = time.monotonic() - t0
        out["volume_bytes"] = host.nbytes
        if vol.state != StageState.READY:
            fail(f"resnet: the stage ended {vol.state}: {vol.error}")
        images = vol.array
        exact = (tuple(images.shape) == shape and images.dtype == torch.uint8
                 and torch.equal(images, torch.from_numpy(host).to(images.device)))
        say(f"  staged {n} uint8 images [{n},{size},{size},3] ({host.nbytes} bytes) in "
            f"{out['stage_s']:.3f} s ({host.nbytes / out['stage_s'] / 1e9:.2f} GB/s); equal "
            f"to the file byte for byte: {exact}")
        if not exact:
            fail("resnet: the staged images differ from the file")
        del host
        labels = torch.from_numpy(np.random.RandomState(0).randint(0, RESNET_CLASSES, n)).to(
            images.device, torch.int32)

        def batches(start):
            """bench.py's one_step slices of the staged volume, batch start on."""
            for i in itertools.count(start):
                lo = (i * batch) % (n - batch + 1)
                yield {"images": images[lo:lo + batch], "labels": labels[lo:lo + batch]}

        # -- train, checkpointing every RESNET_CKPT_EVERY steps --
        ckpt_dir = os.path.join(tmp, "ckpt")
        cfg = TrainConfig(model="resnet50", batch_size=batch, image_size=size,
                          num_classes=RESNET_CLASSES, warmup_steps=2,
                          total_steps=RESNET_STEPS, log_every=1, checkpoint_dir=ckpt_dir,
                          checkpoint_every=RESNET_CKPT_EVERY)
        trainer = Trainer(cfg, device="cuda")
        trainer.init()
        init_extra = [t.clone() for t in tree_leaves(trainer.state.extra)]
        feed = SeekableFeed(batches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.monotonic()
        trainer.run(steps=RESNET_CKPT_EVERY, data=feed)
        saved = clone_state(trainer.state)  # what the step-4 checkpoint holds
        trainer.run(steps=RESNET_STEPS, data=feed)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = dict(kernels.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        hist = trainer.history
        losses = [r["loss"] for r in hist]
        steady = hist[1:]
        step_s = sum(r["step_s"] for r in steady) / len(steady)
        mfu = sum(r["mfu"] for r in steady) / len(steady)
        extra = list(tree_leaves(trainer.state.extra))
        moved = sum(not torch.equal(a, b) for a, b in zip(init_extra, extra))
        finite = all(bool(t.isfinite().all()) for t in extra)
        say(f"  losses {[round(x, 4) for x in losses]}  (ln {RESNET_CLASSES} = "
            f"{math.log(RESNET_CLASSES):.3f})")
        say(f"  BN running statistics: {moved} of {len(extra)} leaves moved from their init, "
            f"all finite {finite}; K1-K3 launches {launches} (want 0)")
        say(f"  step_s {step_s:.4f} (steps 2..{RESNET_STEPS}; step 1 {hist[0]['step_s']:.4f})  "
            f"images/s {batch / step_s:.1f}  MFU {mfu:.4f} of 989e12 "
            f"({flops_per_step(cfg) / 1e12:.3f} TFLOP a step: 3 x 4.1e9 x {batch})  "
            f"peak mem {peak_gb:.2f} GB  wall {wall:.1f} s")
        if len(losses) != RESNET_STEPS or not all(math.isfinite(x) for x in losses):
            fail(f"resnet: losses not finite or missing: {losses}")
        if abs(losses[0] - math.log(RESNET_CLASSES)) > 1.0:
            fail(f"resnet: first loss {losses[0]} not within 1.0 of ln {RESNET_CLASSES}")
        if not finite or moved != len(extra):
            fail(f"resnet: BN statistics not finite ({finite}) or {len(extra) - moved} "
                 f"leaves never moved")
        if any(launches.values()):
            fail(f"resnet: the ResNet path launched attention kernels: {launches}")
        out.update(losses=losses, step_s=step_s, images_per_s=batch / step_s, mfu=mfu,
                   step1_s=hist[0]["step_s"], flops_per_step=flops_per_step(cfg),
                   peak_mem_gb=peak_gb, train_wall_s=wall, launches=launches)

        # -- eval --
        before = [t.clone() for t in tree_leaves(trainer.state.extra)]
        eval_loss = trainer.evaluate(batches(RESNET_STEPS), 2)
        acc = trainer.last_eval_stats["accuracy"]
        untouched = all(torch.equal(a, b) for a, b in
                        zip(before, tree_leaves(trainer.state.extra)))
        say(f"  eval, 2 batches in inference mode: loss {eval_loss:.4f}, accuracy {acc:.4f}; "
            f"BN state byte-identical after: {untouched}")
        if not (math.isfinite(eval_loss) and 0.0 <= acc <= 1.0 and untouched):
            fail(f"resnet: eval loss {eval_loss}, accuracy {acc}, state untouched {untouched}")
        out["eval"] = {"loss": eval_loss, "accuracy": acc}

        # -- resume from step 4 --
        # As if the run had been cut after its step-4 checkpoint, during
        # the save of step 8: no step-8 directory, a partial temporary one.
        shutil.rmtree(os.path.join(ckpt_dir, str(RESNET_STEPS)))
        os.makedirs(os.path.join(ckpt_dir, f".tmp-{RESNET_STEPS}-0"))
        ckpt_bytes = os.path.getsize(os.path.join(ckpt_dir, str(RESNET_CKPT_EVERY), STATE_FILE))
        resumed = Trainer(cfg, device="cuda")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        start = resumed.init_or_resume()
        torch.cuda.synchronize()
        restore_s = time.monotonic() - t0
        diffs = state_differences(saved, resumed.state)
        say(f"  resume: init_or_resume() -> {start} in {restore_s:.3f} s from a "
            f"{ckpt_bytes / 1e6:.1f} MB checkpoint; restored state differs from the saved "
            f"one in {len(diffs)} places {diffs[:5]}")
        if start != RESNET_CKPT_EVERY or diffs:
            fail(f"resnet: resumed at {start} (want {RESNET_CKPT_EVERY}), or the restored "
                 f"state differs: {diffs[:10]}")
        del saved
        feed = SeekableFeed(batches)
        feed.seek(start)
        resumed.run(steps=RESNET_STEPS, data=feed)
        rlosses = [r["loss"] for r in resumed.history]
        rel = [abs(a - b) / abs(b) for a, b in zip(rlosses, losses[start:])]
        say(f"  resumed steps {start + 1}..{RESNET_STEPS}: losses "
            f"{[round(x, 4) for x in rlosses]}, largest relative difference from the first "
            f"run {max(rel):.2e} (limit {RESNET_REL_TOL})")
        if len(rlosses) != RESNET_STEPS - start or not max(rel) <= RESNET_REL_TOL:
            fail(f"resnet: resumed losses {rlosses} against {losses[start:]}")
        timing = Checkpointer(os.path.join(tmp, "timing"))
        t0 = time.monotonic()
        timing.save(RESNET_STEPS, resumed.state, wait=True)
        save_s = time.monotonic() - t0
        say(f"  checkpoint: {ckpt_bytes} bytes; save {save_s:.3f} s (snapshot to the host "
            f"and write, fsync and rename), restore {restore_s:.3f} s")
        out["checkpoint"] = {"bytes": ckpt_bytes, "save_s": save_s, "restore_s": restore_s,
                             "resumed_at": start, "resumed_losses": rlosses,
                             "max_rel_diff": max(rel)}

        # -- remat: one step from a copy of the same state, the same batch --
        # Plain twice (the card's run-to-run spread), then remat. The loss
        # is the forward's, which remat leaves alone; the gradients that
        # reach the optimizer, their norm and the params after the update
        # are what the recomputation could get wrong.
        base = resumed.state
        del trainer
        one_batch = next(batches(RESNET_STEPS))
        steps = {}
        for name, remat in (("plain", False), ("plain again", False), ("remat", True)):
            t = Trainer(dataclasses.replace(cfg, remat=remat, checkpoint_dir=""), device="cuda")
            t.state = clone_state(base)
            seen = []
            update = t.tx.update

            def keep_grads(grads, *rest, update=update, seen=seen):
                seen.extend(tree_leaves(grads))
                return update(grads, *rest)

            t.tx.update = keep_grads
            gc.collect()
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t.state, stats = t.step_fn(t.state, one_batch)
            loss = float(stats["loss"])
            torch.cuda.synchronize()
            steps[name] = {"loss": loss, "grad_norm": float(stats["grad_norm"]),
                           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                           "above_state_gb": (torch.cuda.max_memory_allocated() - held) / 1e9,
                           "grads": [g.float().cpu() for g in seen],
                           "params": [p.detach().float().cpu()
                                      for p in tree_leaves(t.state.params)]}
            del t, stats, seen
        plain, again, rm = steps["plain"], steps["plain again"], steps["remat"]

        def rel(a, b):
            return abs(a - b) / abs(b)

        def worst_leaf(key, run):
            return max(float((x - y).norm() / y.norm()) for x, y in zip(run[key], plain[key]))

        readings = {run: {"loss": rel(steps[run]["loss"], plain["loss"]),
                          "grad_norm": rel(steps[run]["grad_norm"], plain["grad_norm"]),
                          "grads": worst_leaf("grads", steps[run]),
                          "params": worst_leaf("params", steps[run])}
                    for run in ("plain again", "remat")}
        say(f"  remat: one step from one state and batch: loss {rm['loss']:.6f} against "
            f"{plain['loss']:.6f} without, grad_norm {rm['grad_norm']:.6f} against "
            f"{plain['grad_norm']:.6f}; relative differences from the plain step (grads and "
            f"params: the worst leaf, L2): remat {readings['remat']}, plain again "
            f"{readings['plain again']}; peak memory {rm['peak_mem_gb']:.2f} GB against "
            f"{plain['peak_mem_gb']:.2f} ({rm['above_state_gb']:.2f} against "
            f"{plain['above_state_gb']:.2f} GB above the state)")
        limits = {"loss": RESNET_REL_TOL, "grad_norm": RESNET_REL_TOL,
                  "grads": RESNET_GRAD_TOL, "params": RESNET_REL_TOL}
        over = {k: v for k, v in readings["remat"].items() if not v <= limits[k]}
        if len(rm["grads"]) != len(plain["grads"]) or not rm["grads"] or over:
            fail(f"resnet: the remat step differs from the plain one: {over} "
                 f"(limits {limits}; {len(rm['grads'])} gradient leaves against "
                 f"{len(plain['grads'])})")
        out["remat"] = {"loss": rm["loss"], "plain_loss": plain["loss"],
                        "grad_norm": rm["grad_norm"], "plain_grad_norm": plain["grad_norm"],
                        "rel_diff": readings["remat"], "plain_again_rel_diff":
                        readings["plain again"], "peak_mem_gb": rm["peak_mem_gb"],
                        "plain_peak_mem_gb": plain["peak_mem_gb"],
                        "above_state_gb": rm["above_state_gb"],
                        "plain_above_state_gb": plain["above_state_gb"]}
        del steps, plain, again, rm
        if profile:
            out["profile"] = profile_resnet_step(resumed, one_batch)
        del resumed, base, feed, images, labels, one_batch
        backend.unstage(vol)
        del vol
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 5's llama with remat --
    argv = main_path_argv() + ["--remat"]
    say(f"  python -m oim_tpu_torch.cli.oim_trainer {' '.join(argv)}")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    trainer = oim_trainer.run(argv)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    routes = {name: dict(r) for name, r in kernels.ROUTES.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    llosses = [r["loss"] for r in trainer.history]
    rel = [abs(a - b) / abs(b) for a, b in zip(llosses, llama_main["losses"])]
    want = {"flash_fwd": 2 * LAYERS * STEPS, "flash_bwd_dkv": LAYERS * STEPS,
            "flash_bwd_dq": LAYERS * STEPS}
    say(f"  losses {llosses}; largest relative difference from phase 5's {max(rel):.2e}")
    say(f"  launches {launches} (want {want}: the forward runs again in the backward), "
        f"routes {routes}")
    say(f"  peak memory {peak_gb:.2f} GB against phase 5's {llama_main['peak_mem_gb']:.2f} GB")
    if len(llosses) != STEPS or not max(rel) <= RESNET_REL_TOL:
        fail(f"llama remat: losses {llosses} against phase 5's {llama_main['losses']}")
    for name, count in want.items():
        if launches[name] != count or routes[name]["wgmma"] != count:
            fail(f"llama remat: {name} launched {launches[name]} times ({routes[name]}), "
                 f"want {count} on wgmma")
    out["llama_remat"] = {"losses": llosses, "max_rel_diff": max(rel), "launches": launches,
                          "routes": routes, "peak_mem_gb": peak_gb,
                          "plain_peak_mem_gb": llama_main["peak_mem_gb"]}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def profile_resnet_step(trainer, batch) -> dict:
    """One more ResNet step under torch.profiler: device ms by category
    (convolutions, batch norm and elementwise, the optimizer, the rest),
    the top kernels and the idle share; written to
    chiprun_out/chip_smoke_resnet_profile.json."""
    prof, wall_ms = profiled_train_step(trainer, batch)
    kernels_ = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
                for ev in prof.key_averages()
                if str(ev.device_type).endswith("CUDA") and ev.self_device_time_total > 0
                and not ev.key.startswith("optimizer")]
    busy = sum(k[1] for k in kernels_)
    cats = device_ms_by_category(prof, (OPTIMIZER_RANGE,), RESNET_CATEGORIES,
                                 "batch norm, ReLU and elementwise")
    attributed = sum(cats.values())
    if busy > attributed + 1e-3:
        cats["not attributed to an op"] = busy - attributed
    idle = max(0.0, 1 - busy / wall_ms)
    launches = sum(k[2] for k in kernels_)
    say(f"  profiled ResNet step: wall {wall_ms:.1f} ms (the profiler's host work included), "
        f"device busy {busy:.1f} ms, idle share {idle:.3f}; {launches} kernel launches")
    for cat, ms in sorted(cats.items(), key=lambda c: -c[1]):
        say(f"    {ms:9.3f} ms  {ms / max(busy, 1e-9):6.1%}  {cat}")
    for key, ms, count in sorted(kernels_, key=lambda k: -k[1])[:12]:
        say(f"    {ms:9.3f} ms  x{count:<5d} {key[:100]}")
    result = {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": idle,
              "kernel_launches": launches, "categories": cats, "kernels": kernels_}
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "chip_smoke_resnet_profile.json").write_text(json.dumps(result, indent=1))
    return result


# -- Mixture-of-Experts (phases 10-13) -------------------------------------

# The MoE flagship (scripts/sweep_moe.py:37-42, scripts/capacity_quality.py:
# 66-73): llama3-8b's fields at vocab 32768, dim 2048, 8 layers, 16/8 heads
# of 128, mlp 8192, 4 experts, top-2, gather dispatch, capacity factor 1.25;
# the full vocab's logits (no vocab chunks), B=BATCH, T=SEQ. Nothing is cut.
MOE_OVERRIDES = ("vocab=32768", "dim=2048", "n_layers=8", "n_heads=16", "mlp_dim=8192",
                 "n_experts=4", "vocab_chunk=0")
MOE_STEPS = 4
# Its layers, parameters and active parameters (the JAX package's counts).
MOE_FLAGSHIP_COUNTS = (8, 1_845_594_112, 1_040_287_744)
MOE_TINY_TOL = 1e-4  # f32, card against CPU, TF32 off (phase 4's)
# Gather against einsum dispatch, one bf16 step from one state: the
# einsum combine rounds once where gather rounds per routing round, and a
# route whose top-2/3rd gap falls under the bf16 difference flips in a
# later layer. Loss and grad_norm, sums over every token, have read up to
# 1.28e-4 and 3.35e-4 relative on the H100: the limit is ~3x the larger.
# The worst gradient leaf, which flipped routes move, has read 0.135-0.155
# (relative L2): its limit, ~3x, catches a combine with no gradient (1.0).
MOE_DISPATCH_REL = 1e-3
MOE_DISPATCH_GRAD_REL = 0.5
MOE_SERVE_TAILS, MOE_SERVE_NEW = (40, 7), 32


def moe_flagship():
    """The flagship's llama.Config: llama3-8b with MOE_OVERRIDES."""
    import dataclasses

    from oim_tpu_torch.models import llama

    return dataclasses.replace(llama.LLAMA3_8B, **{
        k: int(v) for k, v in (item.split("=") for item in MOE_OVERRIDES)})


def moe_argv() -> list[str]:
    argv = ["--model", "llama3-8b"]
    for item in MOE_OVERRIDES:
        argv += ["--override", item]
    return argv + ["--steps", str(MOE_STEPS), "--batch-size", str(BATCH), "--seq-len",
                   str(SEQ), "--warmup-steps", "2", "--log-every", "1", "--log-level", "info"]


def phase_moe_agreement() -> dict:
    """Phase 10: llama.tiny with 4 experts (f32) on the card against the
    CPU: the loss, drop fraction and gradients; moe.apply in both dispatch
    modes with drops and at k=1; greedy generate(); the paged steps."""
    import torch

    from oim_tpu_torch.models import generate as gen
    from oim_tpu_torch.models import llama, moe
    from oim_tpu_torch.train.state import tree_leaves

    errors: list[str] = []
    cfg = llama.tiny(n_experts=4)
    host = llama.to_numpy(llama.init(torch.Generator().manual_seed(0), cfg, device="cpu"))
    tokens = torch.randint(0, cfg.vocab, (2, 130), generator=torch.Generator().manual_seed(1))
    res, calls = {}, []
    with patched(moe, "apply", moe_calls(calls)):
        for dev in ("cpu", "cuda"):
            p = llama.from_numpy(host, dev)
            leaves = list(tree_leaves(p))
            for leaf in leaves:
                leaf.requires_grad_(True)
            loss, stats = llama.loss_and_stats(p, tokens.to(dev), cfg)
            grads = torch.autograd.grad(loss, leaves)
            res[dev] = (loss.detach().cpu(), stats["moe_drop_frac"].detach().cpu(),
                        [g.detach().cpu() for g in grads])
    tiny_margin = min(float(moe.router_margin(p["router"], x, c.top_k)) for p, x, c in calls)
    say(f"  llama.tiny, 4 experts, f32 (T=129): loss cpu {float(res['cpu'][0]):.6f} cuda "
        f"{float(res['cuda'][0]):.6f}; moe_drop_frac cpu {float(res['cpu'][1]):.6f} cuda "
        f"{float(res['cuda'][1]):.6f}; smallest top-k router margin {tiny_margin:.3e}")
    check("loss", res["cuda"][0], res["cpu"][0], MOE_TINY_TOL, errors)
    check("moe_drop_frac (a count)", res["cuda"][1], res["cpu"][1], 0.0, errors)
    grad_err = max(max_err(a, b) for a, b in zip(res["cuda"][2], res["cpu"][2]))
    say(f"  gradients ({len(res['cpu'][2])} leaves) max_abs_err {grad_err:.3e}  "
        f"tol {MOE_TINY_TOL:.3e}")
    if not grad_err <= MOE_TINY_TOL:
        errors.append(f"gradients: max_abs_err {grad_err}")
    margins = {"llama.tiny": tiny_margin}

    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 64, 64, generator=g)
    for e, k, cf in ((4, 2, 0.5), (4, 1, 1.0)):
        for dispatch in ("gather", "einsum"):
            mcfg = moe.MoEConfig(n_experts=e, top_k=k, capacity_factor=cf, dispatch=dispatch)
            mp = moe.init(torch.Generator().manual_seed(3), 64, 192, mcfg, torch.float32,
                          device="cpu")
            outs = {}
            for dev in ("cpu", "cuda"):
                leaves = [t.to(dev).requires_grad_(True) for t in mp.values()]
                xd = x.to(dev).requires_grad_(True)
                out, st = moe.apply(dict(zip(mp, leaves)), xd, mcfg, with_stats=True)
                gs = torch.autograd.grad((out * out).sum() + st[0], leaves + [xd])
                outs[dev] = [out.detach().cpu(), st.detach().cpu()] + [t.cpu() for t in gs]
            name = f"moe.apply k={k} cf={cf} {dispatch}"
            margins[name] = float(moe.router_margin(mp["router"], x, k))
            say(f"  {name}: dropped {float(outs['cpu'][1][1]):.4f} (cpu) "
                f"{float(outs['cuda'][1][1]):.4f} (cuda), router margin {margins[name]:.3e}")
            check("  out", outs["cuda"][0], outs["cpu"][0], MOE_TINY_TOL, errors)
            check("  [aux, dropped]", outs["cuda"][1], outs["cpu"][1], MOE_TINY_TOL, errors)
            err = max(max_err(a, b) for a, b in zip(outs["cuda"][2:], outs["cpu"][2:]))
            say(f"    gradients (router, experts, x) max_abs_err {err:.3e}")
            if not err <= MOE_TINY_TOL:
                errors.append(f"{name} gradients: max_abs_err {err}")

    prompt = torch.randint(0, cfg.vocab, (2, 5), generator=g)
    toks = {dev: gen.generate(llama.from_numpy(host, dev), prompt.to(dev), 12, cfg).cpu()
            for dev in ("cpu", "cuda")}
    same = torch.equal(toks["cpu"], toks["cuda"])
    say(f"  greedy generate(), 2 rows x 12 tokens: card equal to CPU: {same}")
    if not same:
        errors.append(f"generate: {toks['cuda'].tolist()} against {toks['cpu'].tolist()}")
    check_paged_steps(cfg, host, "cuda", errors)
    if errors:
        fail("MoE on the card disagrees with the CPU: " + "; ".join(errors))
    return {"router_margins": margins, "loss": float(res["cuda"][0]),
            "moe_drop_frac": float(res["cuda"][1]), "grad_max_abs_err": grad_err}


def leaf_rels(xs, ys) -> list[float]:
    """The relative L2 difference of each pair of two lists of tensors."""
    return [float((x.detach().float() - y.detach().float()).norm() / y.detach().float().norm())
            for x, y in zip(xs, ys)]


def worst_leaf_rel(xs, ys) -> float:
    return max(leaf_rels(xs, ys))


def leaf_names(tree, prefix: str = "") -> list[str]:
    """Key paths of a nested dict's leaves, in tree_leaves order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}/{k}")]
    return [prefix]


def moe_dispatch_by_layer(params, tokens, mcfg) -> list[dict]:
    """Gather against einsum dispatch, layer by layer, from one state and
    batch (no gradient): the share of tokens whose top-k expert set
    differs between the two models' forwards, and each dispatch on the
    gather forward's own FFN input, where the router sees one input and no
    route can flip (max|diff| / max|out|, and whether [aux, dropped] are
    equal)."""
    import dataclasses

    import torch

    from oim_tpu_torch.models import llama, moe

    fwd = {}
    with torch.no_grad():
        for c in (mcfg, dataclasses.replace(mcfg, moe_dispatch="einsum")):
            fwd[c.moe_dispatch] = []
            with patched(moe, "apply", moe_calls(fwd[c.moe_dispatch])):
                llama.loss_and_stats(params, tokens, c)

    def experts(p, x, c):
        probs = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ p["router"].float(), -1)
        return probs.topk(c.top_k, dim=-1).indices.sort(dim=-1).values

    rows = []
    with torch.no_grad():
        for (p, x, c), (_, xe, ce) in zip(fwd["gather"], fwd["einsum"]):
            flipped = (experts(p, x, c) != experts(p, xe, ce)).any(dim=-1)
            out_g, st_g = moe.apply(p, x, c, with_stats=True)
            out_e, st_e = moe.apply(p, x, ce, with_stats=True)
            rows.append({"routes_flipped": float(flipped.float().mean()),
                         "same_input": bool(torch.equal(x, xe)),
                         "out_rel": float((out_e.float() - out_g.float()).abs().max()
                                          / out_g.float().abs().max()),
                         "stats_equal": bool(torch.equal(st_g, st_e))})
    return rows


def phase_moe_main(profile: bool) -> dict:
    """Phase 11: the MoE flagship trained through the CLI, then one step
    from one state and batch with einsum dispatch and one with remat."""
    import dataclasses
    import gc

    import torch

    from oim_tpu_torch import kernels
    from oim_tpu_torch.cli import oim_trainer
    from oim_tpu_torch.models import llama
    from oim_tpu_torch.train import Trainer
    from oim_tpu_torch.train.state import tree_leaves
    from oim_tpu_torch.train.trainer import flops_per_step, synthetic_batches

    argv = moe_argv()
    say(f"  python -m oim_tpu_torch.cli.oim_trainer {' '.join(argv)}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.monotonic()
    trainer = oim_trainer.run(argv)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(kernels.LAUNCHES)
    routes = {name: dict(r) for name, r in kernels.ROUTES.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg, hist = trainer.cfg, trainer.history
    from oim_tpu_torch.common import tracing

    # The CLI installed a fresh span ring for this run.
    obs = check_train_gauges(hist, [s.to_event(0) for s in tracing.recorder().spans()],
                             MOE_STEPS, "MoE main path")
    mcfg = cfg.model_config()
    losses = [r["loss"] for r in hist]
    drops = [r.get("moe_drop_frac") for r in hist]
    want = mcfg.n_layers * MOE_STEPS
    n_total, n_active = llama.num_params(mcfg), llama.num_active_params(mcfg)
    say(f"  {mcfg.n_layers} layers, dim {mcfg.dim}, {mcfg.n_experts} experts top-"
        f"{mcfg.moe_top_k}, {mcfg.moe_dispatch} dispatch, cf {mcfg.moe_capacity_factor}: "
        f"{n_total:,} parameters, {n_active:,} active; {flops_per_step(cfg) / 1e12:.2f} "
        f"TFLOP a step (active)")
    say(f"  losses {losses}  (ln {mcfg.vocab} = {math.log(mcfg.vocab):.3f})")
    say(f"  moe_drop_frac {drops}")
    say(f"  launches {launches}  (want {mcfg.n_layers} x {MOE_STEPS} = {want} each)")
    say(f"  routes {routes}  (want every launch on wgmma)")
    if (mcfg.n_layers, n_total, n_active) != MOE_FLAGSHIP_COUNTS:
        fail(f"MoE main path: the config is not the flagship's {MOE_FLAGSHIP_COUNTS}: {mcfg}")
    if len(losses) != MOE_STEPS or not all(math.isfinite(x) for x in losses):
        fail(f"MoE main path: losses not finite or missing: {losses}")
    if abs(losses[0] - math.log(mcfg.vocab)) > 1.0:
        fail(f"MoE main path: first loss {losses[0]} not within 1.0 of ln {mcfg.vocab}")
    if not all(d is not None and 0.0 <= d < 1.0 for d in drops):
        fail(f"MoE main path: moe_drop_frac missing or outside [0, 1): {drops}")
    for name, _ in KERNELS:
        if launches[name] != want or routes[name]["wgmma"] != want:
            fail(f"MoE main path: {name} launched {launches[name]} times ({routes[name]}), "
                 f"want {want} on wgmma")
    steady = hist[1:]
    step_s = sum(r["step_s"] for r in steady) / len(steady)
    mfu = sum(r["mfu"] for r in steady) / len(steady)
    tokens = BATCH * SEQ
    say(f"  step_s {step_s:.4f} (steps 2..{MOE_STEPS}; step 1 {hist[0]['step_s']:.4f})  "
        f"tokens/s {tokens / step_s:.0f}  MFU {mfu:.4f} of 989e12 on active FLOPs  "
        f"peak mem {peak_gb:.1f} GB  wall {wall:.1f} s")
    out = {"config": dict(item.split("=") for item in MOE_OVERRIDES), "batch": BATCH,
           "seq": SEQ, "params": n_total, "active_params": n_active,
           "flops_per_step": flops_per_step(cfg), "losses": losses, "moe_drop_frac": drops,
           "launches": launches, "routes": routes, "step_s": step_s,
           "step1_s": hist[0]["step_s"], "tokens_per_s": tokens / step_s, "mfu": mfu,
           "peak_mem_gb": peak_gb, "obs": obs, "history": hist}

    if profile:
        out["profile"] = profile_step(trainer, "chip_smoke_moe_profile.json")
    # One step from one state and batch: plain twice (the card's spread),
    # einsum dispatch, remat under dots_with_no_batch_dims.
    base = trainer.state
    del trainer
    gc.collect()
    batch = {"tokens": torch.as_tensor(next(synthetic_batches(
        dataclasses.replace(cfg, seed=cfg.seed + 1)))["tokens"]).cuda()}
    runs = (("plain", {}, False, ""), ("plain again", {}, False, ""),
            ("einsum", {"moe_dispatch": "einsum"}, False, ""),
            ("remat", {}, True, "dots_with_no_batch_dims"))
    ref, readings, names, grads_by_layer = None, {}, leaf_names(base.params), []
    by_layer = moe_dispatch_by_layer(base.params, batch["tokens"], mcfg)
    for name, over, remat, policy in runs:
        t = Trainer(dataclasses.replace(cfg, remat=remat, remat_policy=policy,
                                        checkpoint_dir="",
                                        model_overrides={**cfg.model_overrides, **over}),
                    device="cuda")
        t.state = clone_state(base)
        seen = []
        update = t.tx.update

        def keep_grads(grads, *rest, update=update, seen=seen):
            seen.extend(tree_leaves(grads))
            return update(grads, *rest)

        t.tx.update = keep_grads
        gc.collect()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        t.state, stats = t.step_fn(t.state, batch)
        loss, gnorm = float(stats["loss"]), float(stats["grad_norm"])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        run = {"loss": loss, "grad_norm": gnorm, "step_wall_s": time.monotonic() - t0,
               "moe_drop_frac": float(stats["moe_drop_frac"]), "peak_mem_gb": peak / 1e9,
               "above_held_gb": (peak - held) / 1e9}
        params = list(tree_leaves(t.state.params))
        if ref is None:
            ref = dict(run, grads=seen, params=[p.detach() for p in params])
        else:
            rels = leaf_rels(seen, ref["grads"])
            run.update(loss_rel=abs(loss - ref["loss"]) / abs(ref["loss"]),
                       grad_norm_rel=abs(gnorm - ref["grad_norm"]) / abs(ref["grad_norm"]),
                       grads=max(rels), params=worst_leaf_rel(params, ref["params"]),
                       worst_grad_leaf=names[rels.index(max(rels))])
            if name == "einsum":
                run["grads_by_leaf"] = dict(zip(names, rels))
                grads_by_layer = [max(float((g[i].float() - r[i].float()).norm()
                                            / r[i].float().norm())
                                      for n, g, r in zip(names, seen, ref["grads"])
                                      if n.startswith("/layers/"))
                                  for i in range(mcfg.n_layers)]
        readings[name] = {k: v for k, v in run.items() if not isinstance(v, list)}
        del t, stats, seen, params
    del ref, base
    gc.collect()
    torch.cuda.empty_cache()
    for name, r in readings.items():
        rel = ("" if name == "plain" else
               f"; against plain: loss {r['loss_rel']:.2e}, grad_norm {r['grad_norm_rel']:.2e}, "
               f"grads {r['grads']:.2e}, params {r['params']:.2e} (relative; worst leaf, L2)")
        say(f"  one step, {name:<11s}: loss {r['loss']:.6f} grad_norm {r['grad_norm']:.6f} "
            f"drop {r['moe_drop_frac']:.4f}, {r['step_wall_s']:.4f} s, peak {r['peak_mem_gb']:.1f} "
            f"GB ({r['above_held_gb']:.1f} above what was held before the step){rel}"
            f"{'' if name == 'plain' else '; worst gradient leaf ' + r['worst_grad_leaf']}")
    say("  the einsum step's gradient against plain, by leaf (relative L2): " + ", ".join(
        f"{n} {r:.2e}" for n, r in readings["einsum"]["grads_by_leaf"].items()))
    for i, (row, g) in enumerate(zip(by_layer, grads_by_layer)):
        row["einsum_step_grads"] = g
        say(f"  layer {i}: top-{mcfg.moe_top_k} routes flipped (einsum forward against "
            f"gather) {row['routes_flipped']:.4%}; the dispatch alone, gather's FFN input "
            f"through both: out {row['out_rel']:.2e} of max|out| (limit {BF16_REL_TOL:.4f}), "
            f"[aux, dropped] equal {row['stats_equal']}; the einsum step's gradient, worst "
            f"leaf of the layer, {g:.3e} relative L2")
    bad = [i for i, row in enumerate(by_layer)
           if not (row["out_rel"] <= BF16_REL_TOL and row["stats_equal"])]
    if bad or not by_layer[0]["same_input"] or by_layer[0]["routes_flipped"] != 0:
        fail(f"MoE: einsum dispatch differs from gather on one input (layers {bad}), or the "
             f"first layer's input or routes differ between the two forwards: {by_layer}")
    ein, rm = readings["einsum"], readings["remat"]
    if not (ein["loss_rel"] <= MOE_DISPATCH_REL and ein["grad_norm_rel"] <= MOE_DISPATCH_REL
            and ein["grads"] <= MOE_DISPATCH_GRAD_REL):
        fail(f"MoE: einsum dispatch differs from gather beyond {MOE_DISPATCH_REL} (loss, "
             f"grad_norm) or {MOE_DISPATCH_GRAD_REL} (worst gradient leaf): {ein}")
    limits = {"loss_rel": RESNET_REL_TOL, "grad_norm_rel": RESNET_REL_TOL,
              "grads": RESNET_GRAD_TOL, "params": RESNET_REL_TOL}
    over = {k: rm[k] for k, v in limits.items() if not rm[k] <= v}
    if over:
        fail(f"MoE: the remat step differs from the plain one: {over} (limits {limits})")
    out["one_step"] = readings
    out["dispatch_by_layer"] = by_layer
    return out


def phase_moe_serve(profile: bool) -> dict:
    """Phase 12: ServeEngine on the MoE flagship, full depth, bf16."""
    import gc

    import torch

    from oim_tpu_torch import kernels
    from oim_tpu_torch.models import llama, moe
    from oim_tpu_torch.serve import ServeEngine
    from oim_tpu_torch.train.state import tree_leaves

    cfg = moe_flagship()
    t0 = time.monotonic()
    params = llama.init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    torch.cuda.synchronize()
    say(f"  llama.init on the card: {llama.num_params(cfg):,} params, "
        f"{sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9:.2f} GB, "
        f"{time.monotonic() - t0:.1f} s")
    rs = np.random.RandomState(1)
    reqs = [{"name": f"len{n}", "prompt": rs.randint(0, cfg.vocab, n).tolist(),
             "max_new": MOE_SERVE_NEW, "temperature": 0.0, "seed": i}
            for i, n in enumerate(SERVE_LENGTHS)]
    prefix = rs.randint(0, cfg.vocab, SERVE_PREFIX).tolist()
    reqs += [{"name": f"prefix+{t}", "prompt": prefix + rs.randint(0, cfg.vocab, t).tolist(),
              "max_new": MOE_SERVE_NEW, "temperature": 0.0, "seed": 20 + j, "shared": True}
             for j, t in enumerate(MOE_SERVE_TAILS)]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    from oim_tpu_torch.common import metrics as M

    obs = ServeObs("chip-smoke-moe-serve")
    eng = ServeEngine(params, cfg, device="cuda", **SERVE_ENGINE)
    t0 = time.monotonic()
    as_tuple = [(r["prompt"], r["max_new"], r["temperature"], r["seed"]) for r in reqs]
    # The second shared-prefix request goes in after the first retired and
    # donated its prompt's blocks to the store.
    handles, outs = [], []
    for batch in (as_tuple[:-1], as_tuple[-1:]):
        hs = [eng.submit(p, max_new=n, temperature=t, seed=sd) for p, n, t, sd in batch]
        outs += [h.result(timeout=RESULT_TIMEOUT) for h in hs]
        handles += hs
    wall = time.monotonic() - t0
    for r, h, o in zip(reqs, handles, outs):
        r["out"], r["handle"] = o, h
        if h.finish_reason != "length" or len(o) != r["max_new"]:
            fail(f"MoE serving: {r['name']} ended {h.finish_reason!r} after {len(o)} of "
                 f"{r['max_new']} tokens; engine error: {eng.error}")
    stats = {**eng.stats(), **eng.request_stats()}
    scraped, obs_out = check_burst(obs, reqs, "MoE serving")
    prefix = {"hits": delta(scraped, obs.before, M.SERVE_PREFIX_HITS.name),
              "cache_tokens": delta(scraped, obs.before, M.SERVE_PREFILL_TOKENS.name,
                                    source="cache")}
    if prefix != {"hits": stats["prefix_hits"], "cache_tokens": stats["prefill_tokens_cached"]}:
        fail(f"MoE serving: /metrics reads {prefix}, stats() {stats}")
    eng.stop(drain=True)
    eng.evict_prefix_store()
    eng.evict_host_tier()
    used = eng.pool_stats()["used_pages"]
    if M.SERVE_KV_PAGES_USED.value:
        fail(f"MoE serving: the pages-used gauge reads {M.SERVE_KV_PAGES_USED.value} after "
             "drain and eviction")
    obs_out.update(prefix=prefix, spans=check_phase_spans(obs, reqs, "MoE serving"))
    obs.close()
    say(f"  {len(reqs)} greedy requests of {[len(r['prompt']) for r in reqs]} tokens, "
        f"{MOE_SERVE_NEW} new each: all ended by length; prefix hits {stats['prefix_hits']} "
        f"({stats['prefill_tokens_cached']} tokens from the store); {stats['decode_tokens']} "
        f"decode tokens in {stats['target_steps']} steps; wall {wall:.2f} s; pages used "
        f"after drain and eviction {used}")
    if stats["prefix_hits"] < 1:
        fail(f"MoE serving: the shared-prefix request missed the prefix store: {stats}")
    if used:
        fail(f"MoE serving: {used} pages leaked past drain and eviction")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    calls = []
    result = serve_measure(cfg, params, reqs, "cuda", profile, calls,
                           "chip_smoke_moe_serve_profile.json")
    margin = min(float(moe.router_margin(p["router"], x, c.top_k, set_only=True))
                 for p, x, c in calls)
    say(f"  the 8-row first decode step's smallest top-2 router margin (2nd against 3rd "
        f"expert) over its {len(calls)} layers: {margin:.3e}; "
        f"the decode bound reads all {cfg.n_experts} experts' weights (no-drop routing "
        f"runs every expert on every token's slot)")
    result.update(wall_s=wall, prefix_hits=stats["prefix_hits"], obs=obs_out,
                  prefill_tokens_cached=stats["prefill_tokens_cached"],
                  decode_tokens=stats["decode_tokens"], target_steps=stats["target_steps"],
                  first_decode_min_router_margin=margin,
                  kernel_launches=dict(kernels.LAUNCHES),
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return result


def phase_oim_infer() -> dict:
    """Phase 13: the trainer CLI writes a llama-tiny-moe checkpoint on the
    card; oim-infer restores it and decodes."""
    import contextlib
    import io
    import tempfile

    import torch

    from oim_tpu_torch.cli import oim_infer, oim_trainer
    from oim_tpu_torch.models import generate as gen
    from oim_tpu_torch.train.checkpoint import Checkpointer

    prompt = [[1, 2, 3, 4], [50, 60, 70, 80]]
    with tempfile.TemporaryDirectory(prefix="oim-infer-") as tmp:
        ck = os.path.join(tmp, "ck")
        trainer = oim_trainer.run(["--model", "llama-tiny-moe", "--steps", "3", "--batch-size",
                                   "4", "--seq-len", "64", "--checkpoint-dir", ck,
                                   "--log-level", "warning"])
        mcfg = trainer.cfg.model_config()
        argv = ["--checkpoint-dir", ck, "--model", "llama-tiny-moe", "--prompt",
                ";".join(",".join(map(str, row)) for row in prompt), "--n-new", "16",
                "--log-level", "warning"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = oim_infer.main(argv)
        rows = [[int(t) for t in line.split(",")] for line in buf.getvalue().split()]
        params = Checkpointer(ck).restore(device="cuda").params
        want = gen.generate(params, torch.tensor(prompt, device="cuda"), 16, mcfg).tolist()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                empty_rc = oim_infer.main(["--checkpoint-dir", os.path.join(tmp, "empty"),
                                           "--model", "llama-tiny-moe", "--log-level",
                                           "warning"])
        except SystemExit as e:  # a message exits with status 1
            empty_rc = 1 if isinstance(e.code, str) else e.code
    say(f"  python -m oim_tpu_torch.cli.oim_infer {' '.join(argv)} -> exit {rc}")
    for row in rows:
        say(f"    {','.join(map(str, row))}")
    say(f"  rows equal to generate() on the restored params: {rows == want}; with no "
        f"checkpoint: exit {empty_rc!r}")
    if rc != 0 or rows != want:
        fail(f"oim-infer: exit {rc}, rows {rows} against generate() {want}")
    if empty_rc in (0, None):
        fail("oim-infer: a directory without a checkpoint did not exit nonzero")
    return {"rows": rows, "equal_to_generate": True, "no_checkpoint_exit": empty_rc}


# -- sources (phase 14) ----------------------------------------------------

# One-card cuts of real deployments, each volume >= 1 GiB (phase_sources).
SRC_TF_SHARDS = 8                       # ImageNet's train split: 1,024 shards
SRC_TF_SHARD_BYTES = 128 << 20          # of about this size each
SRC_TF_IMAGE_BYTES = (96_000, 124_000)  # ~110 KB a JPEG (seeded bytes, not decoded)
SRC_WDS_SHARDS = 4
SRC_WDS_SHARD_BYTES = 256 << 20
SRC_CEPH_BYTES = 1 << 30
SRC_CACHE = 8 << 30                     # stage-cache capacity: every volume fits
SRC_BLOCK = 256 << 20                   # bytes generated and written at a time


class _GatewayHandler(http.server.BaseHTTPRequestHandler):
    """An object gateway: the URL path names a file under the server's
    root; HEAD, ranged GET (``sendfile``), an ETag from the file's mtime
    and size (as nginx makes it: a rewrite moves it), and HTTP Basic auth
    where an object asks for it."""

    def log_message(self, *args):
        pass

    def _object(self):
        gw = self.server
        need = gw.auth.get(self.path)
        if need and self.headers.get("Authorization") != need:
            self.send_error(401, "unauthorized")
            return None
        path = os.path.join(gw.root, self.path.lstrip("/"))
        try:
            st = os.stat(path)
        except OSError:
            self.send_error(404, "no such object")
            return None
        return path, st.st_size, f'"{st.st_mtime_ns:x}-{st.st_size:x}"'

    def _headers(self, code: int, length: int, etag: str, extra=()) -> None:
        self.send_response(code)
        self.send_header("Content-Length", str(length))
        self.send_header("ETag", etag)
        for k, v in extra:
            self.send_header(k, v)
        self.end_headers()

    def do_HEAD(self):
        obj = self._object()
        if obj is not None:
            self._headers(200, obj[1], obj[2])

    def do_GET(self):
        obj = self._object()
        if obj is None:
            return
        path, size, etag = obj
        start, end, code, extra = 0, size - 1, 200, ()
        rng = self.headers.get("Range", "")
        if rng.startswith("bytes="):
            lo, _, hi = rng[len("bytes="):].partition("-")
            start, end = int(lo), min(int(hi) if hi else size - 1, size - 1)
            code, extra = 206, (("Content-Range", f"bytes {start}-{end}/{size}"),)
        self._headers(code, end - start + 1, etag, extra)
        with open(path, "rb") as f:
            self.connection.sendfile(f, start, end - start + 1)


def _serve_gateway(root: str, auth: dict, port_pipe) -> None:
    """The gateway process: serves ``root`` on a free loopback port, sends
    the port back, and runs until it is terminated."""
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _GatewayHandler)
    server.daemon_threads = True
    server.root, server.auth = root, auth
    port_pipe.send(server.server_port)
    port_pipe.close()
    server.serve_forever()


def basic_auth(user: str, secret: str) -> str:
    return "Basic " + base64.b64encode(f"{user}:{secret}".encode()).decode()


@contextlib.contextmanager
def object_gateway(root: str, auth: dict):
    """The gateway in a process of its own (as a real gateway is: it does
    not share the stager's interpreter lock); yields its base URL and
    stops the process on the way out."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_serve_gateway, args=(root, auth, send), daemon=True,
                       name="oim-gateway")
    proc.start()
    try:
        if not recv.poll(60):
            fail("sources: the object gateway did not start")
        yield f"http://127.0.0.1:{recv.recv()}"
    finally:
        proc.terminate()
        proc.join(30)
        if proc.is_alive():
            proc.kill()
            proc.join(30)


def fsync_file(path: str) -> None:
    with open(path, "rb+") as f:
        os.fsync(f.fileno())


def write_tfrecord_shards(tmp: str, seed: int = 8) -> tuple[list[str], list[int]]:
    """SRC_TF_SHARDS TFRecord files of framed tf.Examples in the ImageNet
    convention: ``image/encoded`` (seeded bytes of SRC_TF_IMAGE_BYTES),
    ``image/class/label`` in 1..1000, height, width and format. Returns
    the paths and every record's label, in order."""
    from oim_tpu_torch.data import readers

    rng = np.random.default_rng(seed)
    paths, labels = [], []
    for i in range(SRC_TF_SHARDS):
        blob = rng.integers(0, 256, SRC_TF_SHARD_BYTES + SRC_TF_IMAGE_BYTES[1],
                            dtype=np.uint8).tobytes()
        records, pos = [], 0
        while pos < SRC_TF_SHARD_BYTES:
            n = int(rng.integers(*SRC_TF_IMAGE_BYTES))
            label = int(rng.integers(1, 1001))
            records.append(readers.encode_example({
                "image/encoded": blob[pos:pos + n], "image/class/label": label,
                "image/height": int(rng.integers(200, 800)),
                "image/width": int(rng.integers(200, 800)), "image/format": b"JPEG"}))
            labels.append(label)
            pos += n
        path = os.path.join(tmp, f"train-{i:05d}-of-01024")
        readers.write_tfrecords(path, records)
        fsync_file(path)
        paths.append(path)
    return paths, labels


def write_token_shards(tmp: str, vocab: int, seed: int = 9) -> tuple[list[str], np.ndarray]:
    """SRC_WDS_SHARDS webdataset tars of ``.bin`` members, each SEQ + 1
    seeded int32 tokens in [0, vocab) (one training record), written with
    ``tarfile``. Returns the paths and every token, in order."""
    rng = np.random.default_rng(seed)
    member = 512 + -(-(SEQ + 1) * 4 // 512) * 512  # header + padded payload
    per_shard = -(-SRC_WDS_SHARD_BYTES // member)
    paths, tokens = [], []
    for i in range(SRC_WDS_SHARDS):
        toks = rng.integers(0, vocab, (per_shard, SEQ + 1), dtype=np.int32)
        path = os.path.join(tmp, f"pretrain-{i:06d}.tar")
        with tarfile.open(path, "w") as tf:
            for j, row in enumerate(toks):
                info = tarfile.TarInfo(f"{i:06d}/{j:08d}.bin")
                info.size = row.nbytes
                tf.addfile(info, io.BytesIO(row.tobytes()))
        fsync_file(path)
        paths.append(path)
        tokens.append(toks.reshape(-1))
    return paths, np.concatenate(tokens)


def write_object(path: str, nbytes: int, seed: int = 10) -> None:
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        for a in range(0, nbytes, SRC_BLOCK):
            rng.integers(0, 256, min(SRC_BLOCK, nbytes - a), dtype=np.uint8).tofile(f)
        f.flush()
        os.fsync(f.fileno())


def check_against_files(arr, paths: list[str], what: str) -> None:
    """The staged uint8 tensor against the files laid back to back."""
    import torch

    pos = 0
    for path in paths:
        size = os.path.getsize(path)
        for a in range(0, size, SRC_BLOCK):
            n = min(SRC_BLOCK, size - a)
            want = torch.from_numpy(np.fromfile(path, np.uint8, count=n, offset=a)).to(arr.device)
            got = arr[pos + a:pos + a + n]
            if got.numel() != n or not torch.equal(got, want):
                fail(f"sources: {what} differs from {os.path.basename(path)} in bytes "
                     f"[{a}, {a + n}) (volume offset {pos + a})")
        pos += size
    if pos != arr.numel():
        fail(f"sources: {what} holds {arr.numel()} bytes, the files {pos}")


def source_read_gbps(src) -> float:
    """The volume read alone through the plane's readers (the engine for
    files, ranged GETs for objects) into a pinned FED_CHUNK buffer, chunk
    by chunk as a stage reads it (host clock)."""
    import torch

    from oim_tpu_torch.data import plane

    buf = torch.empty(FED_CHUNK, dtype=torch.uint8, pin_memory=True).numpy()
    t0 = time.monotonic()
    for off in range(0, src.total_bytes, FED_CHUNK):
        plane.read_range(src, off, buf[:min(FED_CHUNK, src.total_bytes - off)])
    return src.total_bytes / (time.monotonic() - t0) / 1e9


def phase_sources(others: dict) -> dict:
    """Phase 14: the data plane's other sources staged through
    ``CUDABackend()`` (its default cuda device) and checked on the card.

    Cuts, each volume a one-card slice of a real deployment:
    - TFRecord: SRC_TF_SHARDS of ImageNet's 1,024 train shards (~128 MiB
      of framed tf.Examples each, ~110 KB seeded image bytes a record,
      not decoded): 1 GiB.
    - webdataset by URL (configuration 5's path): SRC_WDS_SHARDS tars of
      ~256 MiB of ``.bin`` members, SEQ + 1 seeded int32 tokens each, in
      llama3-8b's vocab: 1 GiB, ~477 M tokens of a pretraining corpus.
    - ceph: one SRC_CEPH_BYTES object behind the gateway, Basic auth.
    The object gateway is a ThreadingHTTPServer on 127.0.0.1, in a process
    of its own, serving the files: its rate is the host's loopback, not a
    network's."""
    import gc
    import shutil
    import tempfile

    import torch

    from oim_tpu_torch.controller import CUDABackend, StagedVolume, StageState
    from oim_tpu_torch.data import objectstore, plane, readers, staging
    from oim_tpu_torch.data.feeds import _wds_tokens
    from oim_tpu_torch.models import llama
    from oim_tpu_torch.spec import ArraySpec, CephParams, TFRecordParams, WebDatasetParams

    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    h2d = h2d_gbps()
    out: dict = {"h2d_gbps": h2d, "chunk_bytes": FED_CHUNK,
                 "gateway": "ThreadingHTTPServer on 127.0.0.1 in its own process: loopback, "
                            "the host's rate, not a network's"}
    backend = CUDABackend(cache_bytes=SRC_CACHE, chunk_bytes=FED_CHUNK)
    sobs = StageObs()
    sobs.backends.append(backend)
    staged: dict = {}

    def expect_staged(name: str, got: float, want: int) -> None:
        staged[name] = got
        if got != want:
            fail(f"sources: {name} staged {want} bytes, oim_staged_bytes_total rose by {got}")

    def stage(kind: str, params, name: str):
        vol = StagedVolume(name, b"", ArraySpec())
        calls = plane.STAGE_CALLS
        t0 = time.monotonic()
        backend.stage(vol, kind, params)
        vol.wait()
        return vol, time.monotonic() - t0, plane.STAGE_CALLS - calls

    def cold(kind: str, params, name: str, source: str) -> tuple:
        """A first stage: READY through one plane call, its time, rate and
        breakdown against the bound from this run's halves."""
        (vol, stage_s, calls), got = sobs.staged(lambda: stage(kind, params, name))
        if vol.state != StageState.READY or calls != 1:
            fail(f"sources: {name} ended {vol.state} after {calls} plane calls: {vol.error}")
        bd = dict(plane.LAST_STAGE_BREAKDOWN)
        read_path = staging.read_path()
        nbytes = vol.array.numel()
        expect_staged(f"{name} stage ({source})", got, nbytes)
        read, got = sobs.staged(lambda: source_read_gbps(plane.lower_source(kind, params)))
        expect_staged(f"{name} read alone", got, nbytes)
        halves = (nbytes / (read * 1e9), nbytes / (h2d * 1e9))
        rec = {"volume_bytes": nbytes, "stage_s": stage_s, "stage_gbps": nbytes / stage_s / 1e9,
               "breakdown": bd, "read_gbps": read, "bound_s": max(halves),
               "bound_by": "read" if halves[0] >= halves[1] else "h2d",
               "stage_over_bound": stage_s / max(halves)}
        say(f"  {name}: {nbytes / 2**30:.2f} GiB staged in {stage_s:.3f} s, "
            f"{rec['stage_gbps']:.2f} GB/s; breakdown {source}_s {bd['disk_s']:.3f}, h2d_s "
            f"{bd['h2d_s']:.3f}, dispatch_s {bd['dispatch_s']:.3f}; the source read alone "
            f"{read:.2f} GB/s, pinned H2D {h2d:.2f} GB/s: bound {rec['bound_s']:.3f} s "
            f"({rec['bound_by']}), stage / bound {rec['stage_over_bound']:.2f}")
        return vol, rec, read_path

    def restage_hits(vol, kind: str, params, name: str) -> float:
        ptr = vol.array.data_ptr()
        backend.unstage(vol)
        (hit, hit_s, calls), got = sobs.staged(lambda: stage(kind, params, name))
        expect_staged(f"{name} cache hit", got, 0)
        same = hit.array is not None and hit.array.data_ptr() == ptr
        say(f"  {name} restaged unchanged: {hit_s * 1e3:.2f} ms, plane calls {calls}, "
            f"same storage {same}")
        if hit.state != StageState.READY or calls or not same:
            fail(f"sources: the unchanged restage of {name} was not a cache hit")
        backend.unstage(hit)
        return hit_s

    vocab = llama.LLAMA3_8B.vocab
    secret = "oim-gateway-secret"
    with tempfile.TemporaryDirectory(prefix="oim-sources-") as tmp, object_gateway(
            tmp, {"/rbd/oim-image-0": basic_auth("oim", secret)}) as gw:
        need = SRC_TF_SHARDS * SRC_TF_SHARD_BYTES + SRC_WDS_SHARDS * SRC_WDS_SHARD_BYTES \
            + SRC_CEPH_BYTES + (1 << 30)
        free = shutil.disk_usage(tmp).free
        if free < need:
            fail(f"sources: the temp disk at {tmp} has {free / 2**30:.1f} GiB free, the "
                 f"volumes need {need / 2**30:.1f} GiB: cut the SRC_ sizes")

        # -- TFRecord --
        t0 = time.monotonic()
        tf_paths, labels = write_tfrecord_shards(tmp)
        say(f"  wrote {SRC_TF_SHARDS} TFRecord shards, {len(labels)} tf.Examples, in "
            f"{time.monotonic() - t0:.1f} s")
        params = TFRecordParams(tuple(tf_paths))
        vol, rec, read_path = cold("tfrecord", params, "tfrecord", "disk")
        if read_path != "native":
            fail(f"sources: the TFRecord stage read through {read_path}, not the native engine")
        rec["read_path"] = read_path
        check_against_files(vol.array, tf_paths, "the TFRecord volume")
        t0 = time.monotonic()
        host = vol.array.cpu().numpy()
        got = [int(readers.parse_example(r)["image/class/label"][0])
               for r in readers.iter_tfrecord_bytes(host)]
        del host
        say(f"  TFRecord volume equal to its files; copied back and walked: {len(got)} "
            f"records, labels equal to those written {got == labels} "
            f"({time.monotonic() - t0:.1f} s)")
        if got != labels:
            fail(f"sources: {len(got)} TFRecord labels read back, {len(labels)} written, "
                 "or a label differs")
        rec.update(shards=SRC_TF_SHARDS, records=len(labels),
                   cache_hit_s=restage_hits(vol, "tfrecord", params, "tfrecord"))
        out["tfrecord"] = rec
        backend.cache.evict_idle()
        for path in tf_paths:
            os.unlink(path)

        # -- webdataset by URL --
        t0 = time.monotonic()
        wds_paths, written = write_token_shards(tmp, vocab)
        urls = [f"{gw}/{os.path.basename(p)}" for p in wds_paths]
        say(f"  wrote {SRC_WDS_SHARDS} webdataset shards, {written.size // (SEQ + 1)} "
            f"samples of {SEQ + 1} tokens, in {time.monotonic() - t0:.1f} s; served at {gw}")
        params = WebDatasetParams(tuple(urls))
        vol, rec, _ = cold("webdataset", params, "webdataset-url", "network")
        check_against_files(vol.array, wds_paths, "the webdataset volume")
        t0 = time.monotonic()
        host = vol.array.cpu().numpy()
        tokens = _wds_tokens(host)
        equal = tokens.shape == written.shape and bool(np.array_equal(tokens, written))
        del host
        say(f"  webdataset volume equal to its shards; _wds_tokens recovered {tokens.size} "
            f"tokens, equal to those written {equal} ({time.monotonic() - t0:.1f} s)")
        if not equal:
            fail("sources: the tokens recovered from the webdataset volume differ from "
                 "those written")
        train_tokens = torch.from_numpy(tokens.copy()).cuda()
        del tokens, written
        rec["cache_hit_s"] = restage_hits(vol, "webdataset", params, "webdataset-url")
        etag = objectstore.object_validators(urls[-1])[0]
        with open(wds_paths[-1], "r+b") as f:  # one token of the last shard, same size
            f.seek(512)
            old = np.frombuffer(f.read(4), np.int32)[0]
            f.seek(512)
            f.write(np.int32((old + 1) % vocab).tobytes())
        if objectstore.object_validators(urls[-1])[0] == etag:
            fail("sources: the gateway's ETag did not move with the shard's bytes")
        misses = backend.cache.stats()["misses"]
        (changed, changed_s, calls), got = sobs.staged(
            lambda: stage("webdataset", params, "webdataset-url"))
        expect_staged("webdataset-url changed restage", got, rec["volume_bytes"])
        missed = backend.cache.stats()["misses"] - misses
        say(f"  one shard's bytes and ETag changed: restage {changed_s:.3f} s, plane calls "
            f"{calls}, cache misses {missed}")
        if changed.state != StageState.READY or calls != 1 or missed != 1:
            fail(f"sources: a changed shard restaged {changed.state} with {calls} plane "
                 f"calls and {missed} misses, want READY, 1 and 1")
        check_against_files(changed.array, wds_paths, "the changed webdataset volume")
        rec.update(shards=SRC_WDS_SHARDS, samples=train_tokens.numel() // (SEQ + 1),
                   changed_restage_s=changed_s)
        out["webdataset_url"] = rec
        backend.unstage(changed)
        del changed, vol
        backend.cache.evict_idle()
        for path in wds_paths:
            os.unlink(path)

        # -- ceph through the gateway --
        os.mkdir(os.path.join(tmp, "rbd"))
        obj = os.path.join(tmp, "rbd", "oim-image-0")
        write_object(obj, SRC_CEPH_BYTES)
        params = CephParams(monitors=gw, user="oim", secret=secret, pool="rbd",
                            image="oim-image-0")
        vol, rec, _ = cold("ceph", params, "ceph", "network")
        check_against_files(vol.array, [obj], "the ceph volume")
        say("  ceph volume equal to its object")
        backend.unstage(vol)
        del vol
        backend.cache.evict_idle()
        gc.collect()
        base = torch.cuda.memory_allocated()
        (wrong, _, _), got = sobs.staged(lambda: stage(
            "ceph", CephParams(monitors=gw, user="oim", secret="wrong", pool="rbd",
                               image="oim-image-0"), "ceph-wrong"))
        expect_staged("ceph with a wrong secret", got, 0)
        gc.collect()
        after = torch.cuda.memory_allocated()
        say(f"  a wrong secret: {wrong.state}, {wrong.error!r}; memory_allocated {after} "
            f"against {base} before")
        if wrong.state != StageState.FAILED or "401" not in wrong.error or after != base:
            fail(f"sources: a wrong ceph secret ended {wrong.state} {wrong.error!r} with "
                 f"{after - base} device bytes held")
        rec["wrong_secret_error"] = wrong.error
        out["ceph"] = rec
    out["obs"] = {"staged_bytes": staged, **sobs.check("sources")}
    say(f"  obs: staged bytes by operation {staged}")

    say("  training: phase 5's config on the webdataset volume's tokens")
    out["train"] = train_on_tokens(train_tokens, "sources", others)
    out["train"]["tokens"] = train_tokens.numel()
    del train_tokens
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.monotonic() - t_phase
    say(f"  phase wall {out['wall_s']:.1f} s (writing and walking the volumes included)")
    return out


# ------------------------------------------------- 15. multi-rank ----
#
# Two ranks share the one card over gloo: NCCL refuses two ranks on one
# device, so NCCL runs at world size 1 only. Neither is a multi-GPU speed.

PAR_T = 4096            # the attention check's global length: 2048 positions a rank
PAR_WORLD = 2
PAR_RANK_TIMEOUT = 900  # seconds a rank of the two-rank job may take
PAR_NCCL_TIMEOUT = 240  # seconds the NCCL world-1 process may take
# A meshed run against one rank on the same global batch and initial
# params, every step: the rows (or the sequence halves) go through the
# same kernels and cuBLAS products at other shapes, and each rank's bf16
# gradient share is summed after its own rounding, so the runs differ by
# bf16 roundings in other places. The limits sit between the sound runs'
# readings (loss 2.3e-5, grad_norm 2.9e-5 at worst on one H100) and the
# weakest planted fault's (contiguous RoPE: loss 6.4e-4, grad_norm
# 2.4e-3); PERF.md §6 has the readings.
PAR_LOSS_REL = 1.5e-4
PAR_NORM_REL = 3e-4
# Faults planted in a run of par_runs, which the limits above must catch:
# each rank trains on its own rows only (no sum over data of the kept
# count, the loss or the gradients); the gradients' sum over data alone
# dropped; zigzag's tokens at contiguous RoPE positions; tensor
# parallelism's reduce_from replaced by the plain psum (whose backward
# sums the replicated cotangent again, doubling every gradient below it).
PAR_FAULTS = (("half_batch", "dp"), ("no_grad_sum", "dp"),
              ("contiguous_rope", "tp_sp_zigzag"), ("plain_psum", "tp_sp_model"))
PAR_FAULT_STEPS = 3  # lr is 0 at step 1: step 3's loss is the first after an update


def par_runs(world: int) -> tuple:
    """The trainer runs of phase 15 on ``world`` ranks: (name, trainer flags
    beyond phase 5's, global batch, sequence length, K1 launches a rank per
    layer and step, the pieces each split leaf is cut into). dp and fsdp
    take phase 5's batch (one row a rank at least), zigzag and tensor
    parallelism (model=world) one row of twice its length; on four ranks
    also seq=2,model=2 with zigzag."""
    b = max(BATCH, world)
    runs = [
        ("dp", ["--rules", "dp", "--mesh", f"data={world}"], b, SEQ, 1, 1),
        ("fsdp", ["--rules", "fsdp", "--mesh", f"data=1,fsdp={world}"], b, SEQ, 1, world),
        ("tp_sp_zigzag", ["--rules", "tp_sp", "--mesh", f"data=1,fsdp=1,seq={world},model=1",
                          "--seq-parallel", "zigzag"], 1, 2 * SEQ, world, 1),
        ("tp_sp_model", ["--rules", "tp_sp", "--mesh", f"data=1,fsdp=1,seq=1,model={world}"],
         1, 2 * SEQ, 1, world),
    ]
    if world == 4:
        runs.append(("tp_sp_seq_model", ["--rules", "tp_sp", "--mesh",
                                         "data=1,fsdp=1,seq=2,model=2",
                                         "--seq-parallel", "zigzag"], 1, 2 * SEQ, 2, 2))
    return tuple(runs)


def tp_collectives(batch: int, seq: int, dim: int, layers: int, steps: int,
                   itemsize: int = 2) -> dict:
    """The collective calls and bytes (per rank) of the tensor-parallel run
    (``--mesh data=1,fsdp=1,seq=1,model=N``), written down before it runs.
    A step's forward sums the embedding's rows and, in each layer, the
    attention and MLP outputs ([B, T, D] in the model's dtype of
    ``itemsize`` bytes, ``reduce_from``), takes one pmax of the CE's row
    maxima and sums its sum-exp and label logit ([B*T] f32 each); its
    backward sums each layer's two ``copy_to`` cotangents and the CE's dy
    ([B, T, D]); the grad norm sums the split leaves' squares (one f32).
    Nothing else crosses ranks: the batch and the sequence are whole on
    every rank."""
    act, rows = batch * seq * dim * itemsize, batch * seq * 4
    calls = (1 + 2 * layers + 2) + (2 * layers + 1) + 1
    nbytes = (1 + 2 * layers + 2 * layers + 1) * act + 2 * rows + 4
    return {"calls": {"psum": steps * calls, "pmax": steps},
            "bytes": {"psum": steps * nbytes, "pmax": steps * rows}}


def run_argv(flags: list, batch: int, seq: int, device: str, steps: int = STEPS) -> list:
    return main_path_argv() + flags + ["--batch-size", str(batch), "--seq-len", str(seq),
                                       "--steps", str(steps), "--device", device,
                                       "--log-level", "warning"]


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _rank_entry(fn, rank: int, world: int, backend: str, store: str, device, queue) -> None:
    """A spawned rank on ``device`` (None: ``cuda:<rank>``, a card a rank):
    join the group (FileStore rendezvous), run ``fn(rank, world, device)``
    and put ("ok", rank, result) or ("error", rank, traceback) on the
    queue."""
    import traceback

    sys.path.insert(0, str(ROOT))
    device = device or f"cuda:{rank}"
    try:
        import torch
        import torch.distributed as dist

        kw = {}
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(device)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            if backend == "nccl":
                kw["device_id"] = torch.device(device)
        dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                                world_size=world, **kw)
        try:
            result = fn(rank, world, device)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        queue.put(("ok", rank, result))
    except BaseException:  # the parent fails the run with this traceback
        queue.put(("error", rank, traceback.format_exc()))


def spawn_collect(target, arg_tuples: list, timeout: float, what: str) -> list:
    """``target(*args, queue)`` in a spawned process for each of
    ``arg_tuples``; each puts ("ok", i, result) or ("error", i, traceback)
    on the queue, i its index. The results in order. A process that fails,
    exits without a result or outlives ``timeout`` fails the run, every
    process stopped first."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=target, args=(*args, queue)) for args in arg_tuples]
    for p in procs:
        p.start()
    n = len(procs)
    results, deadline, err = {}, time.monotonic() + timeout, None
    while len(results) < n and err is None:
        try:
            status, i, value = queue.get(timeout=1.0)
        except queue_mod.Empty:
            waiting = sorted(set(range(n)) - set(results))
            dead = [i for i in waiting if procs[i].exitcode is not None]
            if dead:
                err = f"{dead} exited {[procs[i].exitcode for i in dead]} with no result"
            elif time.monotonic() > deadline:
                err = f"{waiting} still running after {timeout} s"
            continue
        if status == "error":
            err = f"{i} failed:\n{value}"
        else:
            results[i] = value
    for p in procs:
        p.join(timeout=30 if err is None else 1)
        if p.is_alive():
            p.kill()
            p.join()
    if err is not None:
        fail(f"{what}: {err}")
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        fail(f"{what}: processes exited {bad}")
    return [results[i] for i in range(n)]


def run_ranks(fn, world: int, backend: str, timeout: float, device) -> list:
    """``fn`` on ``world`` spawned ranks of one group, every rank on
    ``device`` (None: rank r on ``cuda:r``); each rank's result, in rank
    order. A rank that fails or outlives ``timeout`` fails the run, every
    rank stopped first."""
    store = os.path.join(tempfile.mkdtemp(prefix="oim-ranks-"), "store")
    try:
        return spawn_collect(_rank_entry, [(fn, r, world, backend, store, device)
                                           for r in range(world)],
                             timeout, f"multi-rank ({backend}, world {world}), ranks")
    finally:
        shutil.rmtree(os.path.dirname(store), ignore_errors=True)


def check_collectives(rank: int, world: int, device: str) -> dict:
    """Each collective of ``parallel/collectives.py`` once on a tensor on
    ``device``, over a one-axis mesh of the world, against its value from
    the inputs every rank can make (rank r's block is full[r])."""
    import torch

    from oim_tpu_torch.parallel import collectives as C
    from oim_tpu_torch.parallel.mesh import build_mesh

    axis = build_mesh([("x", world)], device=device).axis("x")
    g = torch.Generator(device=device).manual_seed(150)
    full = torch.randn((world, 4 * world, 6), generator=g, device=device)
    mine = full[rank]
    chunk = full.shape[1] // world
    want = {
        "psum": full.sum(0),
        "pmean": full.mean(0),
        "all_gather": torch.cat(list(full), 0),
        "reduce_scatter": full.sum(0)[rank * chunk:(rank + 1) * chunk],
        "all_to_all": torch.cat([full[j][rank * chunk:(rank + 1) * chunk]
                                 for j in range(world)], 0),
        "ppermute_ring": full[(rank - 1) % world],
    }
    got = {
        "psum": C.psum(mine, axis),
        "pmean": C.pmean(mine, axis),
        "all_gather": C.all_gather(mine, axis),
        "reduce_scatter": C.reduce_scatter(mine, axis),
        "all_to_all": C.all_to_all(mine, axis, split_dim=0, concat_dim=0),
        "ppermute_ring": C.ppermute_ring(mine, axis),
    }
    _sync(device)
    errs = {k: float((got[k] - want[k]).abs().max()) for k in want}
    return {"backend": axis.backend, "errors": errs, "index": C.axis_index(axis),
            "size": C.axis_size(axis),
            "on_device": all(t.device == torch.device(device) for t in got.values()),
            "staged_calls": dict(C.STAGED_CALLS), "staged_bytes": dict(C.STAGED_BYTES)}


def _digests(trainer) -> list:
    """(leaf, piece, 2 x int64 digest of its bits) for each leaf this rank
    holds: ranks with the same piece must hold the same bits."""
    import torch

    from oim_tpu_torch.train.state import tree_leaves

    out = []
    names = [n for n, _ in _named_leaves(trainer.state.params)]
    for name, p, s in zip(names, tree_leaves(trainer.state.params),
                          tree_leaves(trainer.shardings)):
        flat = p.detach().reshape(-1)
        ints = flat.view(torch.int16 if flat.element_size() == 2 else torch.int32)
        s1 = torch.zeros((), dtype=torch.int64, device=p.device)
        s2 = torch.zeros((), dtype=torch.int64, device=p.device)
        for start in range(0, ints.numel(), 1 << 26):
            c = ints[start:start + (1 << 26)].long()
            w = torch.arange(start, start + c.numel(), device=p.device) % 65521 + 1
            s1 += c.sum()
            s2 += (c * w).sum()
        piece = tuple(s.parts(trainer.mesh, d)[1] for d in range(len(s.dims)))
        out.append((name, piece, int(s1), int(s2)))
    return out


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _attention_inputs_full(device):
    import torch

    cfg_h, cfg_hkv, d = 32, 8, 128  # llama3-8b's attention
    g = torch.Generator(device=device).manual_seed(151)
    shape_q, shape_kv = (1, PAR_T, cfg_h, d), (1, PAR_T, cfg_hkv, d)
    q, do = (torch.randn(shape_q, generator=g, device=device).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(shape_kv, generator=g, device=device).to(torch.bfloat16)
            for _ in range(2))
    return q, k, v, do


def plain_attention(q, k, v, do, causal: bool) -> dict:
    """out, dq, dk and dv of one attention call by the plain versions of
    K1-K3 (f32 sums; phase 3's reference), delta formed as the autograd
    Functions form it."""
    import importlib

    A = importlib.import_module("oim_tpu_torch.ops.attention")
    b, t, h, d = q.shape
    scale = d ** -0.5
    out, lse = A.flash_forward_plain(q, k, v, causal, scale)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).reshape(b * h, t).contiguous()
    dk, dv = A.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale)
    dq = A.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale)
    return {"out": out, "dq": dq, "dk": dk, "dv": dv}


def sp_attention_check(rank: int, world: int, device: str) -> dict:
    """Ring, zigzag and Ulysses at llama3-8b's attention width (q
    [1,4096,32,128], k/v [1,4096,8,128], bf16, causal), each rank holding
    its 2048 positions, against the plain versions of K1-K3 over all 4096
    on one rank: output and dq/dk/dv on this rank's positions. K1-K3
    launches and routes counted over each sequence-parallel run alone."""
    import torch

    from oim_tpu_torch import kernels
    from oim_tpu_torch.parallel.mesh import build_mesh
    from oim_tpu_torch.parallel.ring import make_sequence_parallel_attention, shard_positions

    q, k, v, do = _attention_inputs_full(device)
    ref = plain_attention(q, k, v, do, causal=True)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()  # the reference's f32 scores
    mesh = build_mesh([("data", 1), ("seq", world)], device=device)
    out = {}
    for kind in ("ring", "zigzag", "ulysses"):
        pos = shard_positions(PAR_T, world, rank, "zigzag" if kind == "zigzag" else "ring")
        idx = torch.from_numpy(pos.astype(np.int64)).to(device)
        q_r, k_r, v_r = (x[:, idx].detach().requires_grad_(True) for x in (q, k, v))
        fn = make_sequence_parallel_attention(mesh, kind=kind, causal=True)
        _sync(device)
        kernels.reset_launches()
        o = fn(q_r, k_r, v_r)
        o.backward(do[:, idx])
        _sync(device)
        launches = dict(kernels.LAUNCHES)
        routes = {n: dict(r) for n, r in kernels.ROUTES.items()}
        errs, tols = {}, {}
        for name, got in (("out", o), ("dq", q_r.grad), ("dk", k_r.grad), ("dv", v_r.grad)):
            errs[name] = max_err(got.detach(), ref[name][:, idx])
            # phase 3's tolerance: relative to the largest value of the whole
            # tensor, which every rank holds in its reference
            tols[name] = BF16_REL_TOL * float(ref[name].abs().max())
            if not bool(got.isfinite().all()):
                errs[name] = float("inf")
        out[kind] = {"launches": launches, "routes": routes, "errors": errs, "tols": tols}
    return out


def train_runs(rank: int, world: int, device: str) -> dict:
    """The trainer CLI on each of ``par_runs(world)`` at llama3-8b width, LAYERS
    layers, STEPS steps, on ``device``; per run: the history,
    K1-K3 launches and routes, collectives staged through host memory,
    peak memory, the bytes of params this rank holds, and its leaves'
    digests."""
    import gc

    import torch

    from oim_tpu_torch import kernels
    from oim_tpu_torch.cli import oim_trainer
    from oim_tpu_torch.models import llama
    from oim_tpu_torch.parallel import collectives as C

    heads: set = set()

    def wrap(attention):
        def seen(q, k, v, **kw):
            heads.add((q.shape[2], k.shape[2]))
            return attention(q, k, v, **kw)
        return seen

    out = {}
    for name, flags, batch, seq, _, _ in par_runs(world):
        argv = run_argv(flags, batch, seq, device)
        gc.collect()
        cuda = torch.device(device).type == "cuda"
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        C.reset_counts()
        heads.clear()
        with patched(llama, "default_attention", wrap):
            trainer = oim_trainer.run(argv)
        _sync(device)
        held, full, whole = _held_bytes(trainer)
        out[name] = {
            "history": trainer.history, "launches": dict(kernels.LAUNCHES),
            "routes": {n: dict(r) for n, r in kernels.ROUTES.items()},
            "staged_calls": dict(C.STAGED_CALLS), "staged_bytes": dict(C.STAGED_BYTES),
            "calls": dict(C.CALLS), "bytes": dict(C.BYTES), "heads": sorted(heads),
            "model_dims": {**{k: getattr(trainer.cfg.model_config(), k)
                              for k in ("n_heads", "n_kv_heads", "dim", "n_layers")},
                           "itemsize": trainer.cfg.model_config().dtype.itemsize},
            "backend": trainer.mesh.axis(trainer.mesh.axis_names[0]).backend,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0,
            "held_bytes": held,
            "full_bytes": full, "whole_bytes": whole,
            "digests": _digests(trainer),
        }
        del trainer
    return out


def planted(fault: str):
    """A ``patched`` context planting ``fault`` (of PAR_FAULTS) in this
    rank's trainer."""
    from oim_tpu_torch.models import llama
    from oim_tpu_torch.parallel import collectives as C
    from oim_tpu_torch.train import trainer as T

    if fault == "plain_psum":
        return patched(C, "reduce_from", lambda reduce_from: C.psum)
    if fault == "contiguous_rope":
        import torch.distributed as dist

        def wrap(loss_and_stats):
            def contiguous(*a, positions=None, **k):
                if positions is not None:  # this rank's run of the sequence
                    t, i = len(positions), dist.get_rank()
                    positions = np.arange(i * t, (i + 1) * t, dtype=positions.dtype)
                return loss_and_stats(*a, positions=positions, **k)
            return contiguous
        return patched(llama, "loss_and_stats", wrap)

    def wrap(psum):
        def dropped(x, axes):
            # the gradients are the step's only psums of more than a scalar
            if fault == "half_batch" or x.dim():
                axes = [a for a in axes if a.name != "data"]
            return psum(x, axes)
        return dropped
    return patched(T, "psum", wrap)


def fault_runs(rank: int, world: int, device: str) -> dict:
    """Each of PAR_FAULTS: its run of ``par_runs(world)`` for
    PAR_FAULT_STEPS steps with the fault planted; the history."""
    import gc

    import torch

    from oim_tpu_torch.cli import oim_trainer

    runs = {name: (flags, batch, seq) for name, flags, batch, seq, _, _ in par_runs(world)}
    out = {}
    for fault, run in PAR_FAULTS:
        flags, batch, seq = runs[run]
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        with planted(fault):
            trainer = oim_trainer.run(run_argv(flags, batch, seq, device, PAR_FAULT_STEPS))
        out[fault] = trainer.history
        del trainer
    return out


# Phase 15, MoE, ResNet and checkpoints across ranks: (a) expert
# parallelism at the MoE flagship's full width and depth; (b) its global
# routing under fsdp, cut to MOE_FSDP_LAYERS layers (gloo's host path
# carries the fsdp gathers and reduce-scatters: 8 layers would take
# minutes), and at MOE_FSDP_CF, a capacity factor that drops half the
# tokens at a random init, for the per-rank routing fault; (c)
# ResNet-50 at bench.py's cell under data=2; (d) checkpoints of (a) and
# (b) at step 2 resumed on the same mesh and on one rank.
MOE_FSDP_LAYERS = 2
MOE_FSDP_CF = 0.5
RESNET_PAR_BATCH = 128
# (b) and (c) run in float32 (TF32 off; K1-K3 then take their fma route):
# in bf16 a rank's partial gradients each round before their sum, and the
# runs part from one rank's by more than the limits after the first
# update (bf16 on one H100: (b) grad_norm rel 1.3e-3 at step 3 as routes
# flip, (c) loss 7.3e-4 and grad_norm 1.4e-2, where the planted per-rank
# batch norm reads 1.7e-3 and 1.6e-2): the same order as the faults.
SLICE12_DTYPE = ["--override", "dtype=float32"]
# (c) in float32 against one rank: cuDNN convolves 64 rows a rank with
# other algorithms than 128, its backward is not deterministic, and
# ResNet's 53 batch norms carry both into the gradient: grad_norm read
# 5.7e-4 to 3.22e-3 at its worst step in four calls on one H100 (one
# rank's own step-4 norm moved by 6.8e-4 between two), the per-rank batch
# norm 3.2e-3. So grad_norm cannot tell the two apart; the loss does
# (sound 2.7e-5 to 9.7e-5, the per-rank batch norm 7.3e-4). Its loss limit,
# in PAR_LOSS_REL's place, sits ~3x above the worst sound reading and
# ~2.4x below the fault; its grad_norm limit, in PAR_NORM_REL's, only
# guards against a gross fault (a gradient not summed over data reads
# ~0.3): ~6x the worst sound reading. The BN running statistics after the
# last step read 3.0e-3 of each leaf's largest value (a per-rank batch
# norm moves them by ~1/sqrt(64)).
RESNET_PAR_LOSS_REL = 3e-4
RESNET_PAR_NORM_REL = 2e-2
RESNET_BN_REL = 1e-2
# Faults planted in the runs above, which the runs' limits must
# catch: each rank routes its own tokens (local capacity and slots), the
# router's columns gathered with the plain all_gather (whose reduce-scatter
# backward doubles the router's gradient over expert=2), batch norm over a
# rank's own rows, and the load-balance loss counted in full on every rank.
SLICE12_FAULTS = (("local_routing", "moe_drops"), ("rs_backward", "ep"),
                  ("rank_bn", "resnet_dp"), ("aux_everywhere", "moe_fsdp"))


def ep_argv(device: str, steps: int = MOE_STEPS, world: int = 0) -> list:
    """(a) on ``world`` ranks (``--mesh ...,expert=world``); 0 is one rank."""
    mesh = f"data=1,fsdp=1,seq=1,model=1,expert={world}"
    return moe_argv() + (["--rules", "tp_sp", "--mesh", mesh] if world else []) + [
        "--steps", str(steps), "--device", device, "--log-level", "warning"]


def moe_fsdp_argv(device: str, steps: int = MOE_STEPS, world: int = 0,
                  capacity_factor: float | None = None) -> list:
    cf = [] if capacity_factor is None else ["--override",
                                             f"moe_capacity_factor={capacity_factor}"]
    return moe_argv() + ["--override", f"n_layers={MOE_FSDP_LAYERS}"] + cf + SLICE12_DTYPE + (
        ["--rules", "fsdp", "--mesh", f"data=1,fsdp={world}"] if world else []) + [
        "--steps", str(steps), "--device", device, "--log-level", "warning"]


def moe_drops_argv(device: str, steps: int = PAR_FAULT_STEPS, world: int = 0) -> list:
    return moe_fsdp_argv(device, steps, world, MOE_FSDP_CF)


def resnet_par_argv(device: str, steps: int = STEPS, world: int = 0) -> list:
    return ["--model", "resnet50", "--batch-size", str(RESNET_PAR_BATCH), "--steps",
            str(steps), "--warmup-steps", "2", "--log-every", "1", "--device", device,
            "--log-level", "warning", *SLICE12_DTYPE] + (
        ["--rules", "dp", "--mesh", f"data={world}"] if world else [])


def slice12_argv(run: str, device: str, steps: int, world: int = 0) -> list:
    return {"ep": ep_argv, "moe_fsdp": moe_fsdp_argv, "moe_drops": moe_drops_argv,
            "resnet_dp": resnet_par_argv}[run](device, steps, world)


def ep_collectives(tokens: int, dim: int, layers: int, experts_here: int, top_k: int,
                   steps: int, checkpointed: bool, itemsize: int = 2) -> dict:
    """The collective calls and bytes (per rank) of the expert-parallel run
    (``--mesh ...,expert=N``), written down before it runs. Each layer's
    forward gathers the router's columns ([D, E/N] f32, ``gather_from``)
    and sums the experts' partial outputs ([tokens, D] in the model's
    dtype, ``reduce_from``); its backward sums the cotangents of the two
    ``copy_to``s (the tokens [tokens, D] and the top-k combine weights
    [k, tokens] f32). The grad norm sums the expert leaves' squares (one
    f32); making the checkpointer agrees on a run id (one int64). Nothing
    else crosses ranks: all hold the same tokens."""
    act = tokens * dim * itemsize
    calls = 3 * layers + 1
    nbytes = layers * (2 * act + top_k * tokens * 4) + 4
    return {"calls": {"psum": steps * calls + int(checkpointed),
                      "gather_from": steps * layers},
            "bytes": {"psum": steps * nbytes + 8 * int(checkpointed),
                      "gather_from": steps * layers * dim * experts_here * 4}}


def planted12(fault: str):
    """A ``patched`` context planting ``fault`` (of SLICE12_FAULTS) in this
    rank's port."""
    import dataclasses

    import torch

    from oim_tpu_torch.models import moe, resnet
    from oim_tpu_torch.parallel import collectives as C

    if fault == "rs_backward":
        return patched(C, "gather_from", lambda gather_from: (
            lambda x, axis, gather_dim=0: C.all_gather(x, axis, gather_dim=gather_dim)))
    if fault == "rank_bn":
        return patched(resnet, "_batchnorm", lambda batchnorm: (
            lambda x, p, s, training, momentum, eps, batch_axes=():
            batchnorm(x, p, s, training, momentum, eps)))

    def wrap(apply):
        def faulty(params, x, cfg, with_stats=False, ctx=None):
            if fault == "local_routing" and ctx is not None:
                ctx = dataclasses.replace(ctx, batch=(), seq=None)
            out, aux = apply(params, x, cfg, with_stats, ctx)
            if fault == "aux_everywhere" and ctx is not None:
                n = math.prod(a.size for a in (*ctx.batch, ctx.seq) if a is not None)
                aux = aux * torch.tensor([float(n), 1.0], device=aux.device)
            return out, aux
        return faulty

    return patched(moe, "apply", wrap)


def _held_bytes(trainer) -> tuple[int, int, int]:
    """(bytes of params this rank holds, their unsharded bytes, bytes of
    the leaves held whole)."""
    from oim_tpu_torch.train.state import tree_leaves

    held = full = whole = 0
    for (_, p), sh in zip(_named_leaves(trainer.state.params), tree_leaves(trainer.shardings)):
        nbytes = p.numel() * p.element_size()
        pieces = math.prod(sh.parts(trainer.mesh, d)[0] for d in range(len(sh.dims)))
        held, full = held + nbytes, full + nbytes * pieces
        whole += nbytes if pieces == 1 else 0
    return held, full, whole


def _host_available_gb() -> float:
    """MemAvailable of /proc/meminfo in GB (0.0 where there is none)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024 / 1e9
    except OSError:
        pass
    return 0.0


def _extra_host(trainer) -> dict:
    return {name: t.detach().float().cpu().numpy() for name, t in
            _named_leaves(trainer.state.extra)}


def _slice12_run(argv: list, device: str) -> dict:
    """One trainer CLI run on this rank: history, K1-K3 launches and
    routes, collectives, peak memory, held bytes, digests, the model's
    state (ResNet's running statistics) and restore seconds."""
    import gc

    import torch

    from oim_tpu_torch import kernels
    from oim_tpu_torch.cli import oim_trainer
    from oim_tpu_torch.parallel import collectives as C
    from oim_tpu_torch.train import checkpoint

    gc.collect()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    C.reset_counts()
    restores: list = []

    def timed(restore):
        def run(self, *a, **k):
            t0 = time.monotonic()
            state = restore(self, *a, **k)
            _sync(device)
            restores.append(time.monotonic() - t0)
            return state
        return run

    with patched(checkpoint.Checkpointer, "restore", timed):
        trainer = oim_trainer.run(argv)
    _sync(device)
    say(f"    ran {' '.join(argv[-8:])}: host memory available {_host_available_gb():.1f} GB")
    held, full, whole = _held_bytes(trainer)
    rec = {"history": trainer.history, "launches": dict(kernels.LAUNCHES),
           "routes": {n: dict(r) for n, r in kernels.ROUTES.items()},
           "calls": dict(C.CALLS), "bytes": dict(C.BYTES),
           "staged_calls": dict(C.STAGED_CALLS), "staged_bytes": dict(C.STAGED_BYTES),
           "backend": trainer.mesh.axis(trainer.mesh.axis_names[-1]).backend,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0,
           "held_bytes": held, "full_bytes": full, "whole_bytes": whole,
           "digests": _digests(trainer), "extra": _extra_host(trainer),
           "restore_s": restores}
    return rec, trainer


def _copy_step(rank: int, src: str, step: int, dsts: list) -> None:
    """Rank 0 copies the committed ``step`` of ``src`` into each of
    ``dsts`` (moves it into the last) once every rank's pieces are in (a
    barrier each side)."""
    import torch.distributed as dist

    dist.barrier()
    if rank == 0:
        for i, dst in enumerate(dsts):
            os.makedirs(dst, exist_ok=True)
            a, b = os.path.join(src, str(step)), os.path.join(dst, str(step))
            shutil.move(a, b) if i == len(dsts) - 1 else shutil.copytree(a, b)
    dist.barrier()


def _save_timing(rank: int, trainer, root: str) -> dict:
    """One blocking save of the trainer's state into a fresh directory: this
    rank's seconds (rank 0's with the commit) and the bytes of its pieces."""
    import torch.distributed as dist

    from oim_tpu_torch.train.checkpoint import Checkpointer, Layout

    ck = Checkpointer(os.path.join(root, "timing"),
                      layout=Layout(trainer.mesh, trainer.shardings))
    t0 = time.monotonic()
    ck.save(trainer.state.step, trainer.state, wait=True)
    seconds = time.monotonic() - t0
    dist.barrier()
    step_dir = os.path.join(root, "timing", str(trainer.state.step))
    nbytes = os.path.getsize(os.path.join(step_dir, f"piece-{ck.layout.member}.pt"))
    dist.barrier()
    if rank == 0:
        shutil.rmtree(os.path.join(root, "timing"))
    return {"save_s": seconds, "piece_bytes": nbytes}


def slice12_job(rank: int, world: int, device: str, root: str, full: bool = True) -> dict:
    """(a) and (c) on this rank, and with ``full`` (b), (d) and
    SLICE12_FAULTS too; the checkpoints under ``root`` (step 2 of (a)
    moved to ``root/ep_one``, of (b) copied to ``root/same`` and
    ``root/one``, for the resumes)."""
    import gc

    import torch.distributed as dist

    out = {}
    ck = ["--checkpoint-every", "2", "--checkpoint-dir"]
    out["ep"], trainer = _slice12_run(
        ep_argv(device, world=world) + (ck + [f"{root}/ep"] if full else []), device)
    del trainer
    if full:
        # Each directory goes once it has served: (a)'s state is ~11 GB.
        _copy_step(rank, f"{root}/ep", 2, [f"{root}/ep_one"])
        if rank == 0:
            shutil.rmtree(f"{root}/ep")
        out["moe_fsdp"], trainer = _slice12_run(
            moe_fsdp_argv(device, world=world) + ck + [f"{root}/fsdp"], device)
        out["moe_fsdp"]["checkpoint"] = _save_timing(rank, trainer, root)
        del trainer
        _copy_step(rank, f"{root}/fsdp", 2, [f"{root}/same", f"{root}/one"])
        if rank == 0:
            shutil.rmtree(f"{root}/fsdp")
        out["resume_same"], trainer = _slice12_run(
            moe_fsdp_argv(device, world=world) + ck + [f"{root}/same"], device)
        del trainer
        dist.barrier()  # the resumed run's last step is committed
        if rank == 0:
            shutil.rmtree(f"{root}/same")
    out["resnet_dp"], trainer = _slice12_run(resnet_par_argv(device, world=world), device)
    del trainer
    if full:
        faults = {}
        for fault, run in SLICE12_FAULTS:
            gc.collect()
            with planted12(fault):
                faults[fault], trainer = _slice12_run(
                    slice12_argv(run, device, PAR_FAULT_STEPS, world), device)
            del trainer
        out["faults"] = {f: r["history"] for f, r in faults.items()}
    return out


def ranks_job(rank: int, world: int, device: str, root: str, full: bool = True,
              volumes: dict | None = None) -> dict:
    """Every multi-rank run of phase 15 on this rank; slice 14's (i) and
    (j) where ``volumes`` (``slice14_volumes``) are given."""
    return {"collectives": check_collectives(rank, world, device),
            "attention": sp_attention_check(rank, world, device),
            "train": train_runs(rank, world, device),
            "faults": fault_runs(rank, world, device),
            "slice12": slice12_job(rank, world, device, root, full),
            "pipe": pipe_job(rank, world, device, full),
            "slice14": slice14_job(rank, world, device, volumes) if volumes else None}


def nccl_world1_job(rank: int, world: int, device: str) -> dict:
    """NCCL at world size 1: each collective once on a CUDA tensor, then
    phase 5's config for 2 steps through the meshed path (--mesh data=1)."""
    import torch

    from oim_tpu_torch import kernels
    from oim_tpu_torch.cli import oim_trainer
    from oim_tpu_torch.parallel import collectives as C

    coll = check_collectives(rank, world, device)
    C.reset_counts()
    kernels.reset_launches()
    trainer = oim_trainer.run(run_argv(["--mesh", "data=1"], BATCH, SEQ, device, steps=2))
    _sync(device)
    return {"collectives": coll, "history": trainer.history,
            "launches": dict(kernels.LAUNCHES),
            "routes": {n: dict(r) for n, r in kernels.ROUTES.items()},
            "calls": dict(C.CALLS), "staged_calls": dict(C.STAGED_CALLS),
            "backend": trainer.mesh.axis("data").backend}


def _check_collective_result(res: dict, what: str, backend: str) -> None:
    errs = res["errors"]
    say(f"  {what}: backend {res['backend']}, index {res['index']} of {res['size']}, "
        f"max |err| {max(errs.values()):.2e} ({', '.join(errs)}), "
        f"staged through host memory {sum(res['staged_calls'].values())} call(s)")
    if res["backend"] != backend or not res["on_device"]:
        fail(f"{what}: backend {res['backend']} (want {backend}), results on the rank's "
             f"device {res['on_device']}")
    if max(errs.values()) > 1e-5:
        fail(f"{what}: collectives disagree with their values: {errs}")
    if backend == "nccl" and sum(res["staged_calls"].values()):
        fail(f"{what}: NCCL staged {res['staged_calls']} through host memory")


def one_rank_references(world: int, device: str, main: dict | None = None) -> dict:
    """The history (STEPS steps) of each of ``par_runs(world)`` on one
    process with the run's global batch and initial params: phase 5's
    where the batch is phase 5's, else a run of the CLI here."""
    import gc

    import torch

    from oim_tpu_torch.cli import oim_trainer

    by_batch = {(BATCH, SEQ): main["history"]} if main is not None else {}
    refs = {}
    for name, _, batch, seq, _, _ in par_runs(world):
        if (batch, seq) not in by_batch:
            by_batch[(batch, seq)] = oim_trainer.run(run_argv([], batch, seq, device)).history
            gc.collect()
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
        refs[name] = by_batch[(batch, seq)]
    return refs


def deviation(hists: list, ref: list) -> tuple[float, float]:
    """The largest relative difference of loss and of grad_norm, over the
    steps of every rank's history, from the one-rank history ``ref``."""
    def rel(key):
        return max(abs(h[key] - r[key]) / abs(r[key])
                   for hist in hists for h, r in zip(hist, ref, strict=False))
    if any(len(hist) > len(ref) for hist in hists):
        fail(f"a run of {max(map(len, hists))} steps against a reference of {len(ref)}")
    return rel("loss"), rel("grad_norm")


def check_ranks(ranks: list, world: int, single: dict, backend: str) -> dict:
    """The checks of phase 15 on the results of ``ranks_job`` on every rank:
    the collectives, sequence-parallel attention against one rank with the
    schedule's launches, and each trainer run against ``single`` (from
    ``one_rank_references``)."""
    for r, res in enumerate(ranks):
        _check_collective_result(res["collectives"], f"{backend} collectives, rank {r}",
                                 backend)
    # Sequence-parallel attention against one rank.
    k1_want = {"ring": [i + 1 for i in range(world)], "zigzag": [world] * world,
               "ulysses": [1] * world}
    attn = {}
    for kind, want in k1_want.items():
        per_rank = [res["attention"][kind] for res in ranks]
        launches = [{n: pr["launches"][n] for n, _ in KERNELS} for pr in per_rank]
        errs = {t: max(pr["errors"][t] for pr in per_rank) for t in ("out", "dq", "dk", "dv")}
        tols = per_rank[0]["tols"]
        say(f"  {kind:<8s} q [1,{PAR_T},32,128] k/v [1,{PAR_T},8,128] bf16 causal, "
            f"{PAR_T // world} positions a rank: max |err| vs one rank "
            + ", ".join(f"{t} {errs[t]:.3e} (tol {tols[t]:.3e})" for t in errs)
            + f"; launches by rank {launches}")
        for t in errs:
            if not errs[t] <= tols[t]:
                fail(f"{kind} attention: {t} max |err| {errs[t]} > {tols[t]}")
        for r, (pr, lw) in enumerate(zip(per_rank, want)):
            for n, _ in KERNELS:
                if pr["launches"][n] != lw or pr["routes"][n]["wgmma"] != lw:
                    fail(f"{kind} attention, rank {r}: {n} launched {pr['launches'][n]} "
                         f"({pr['routes'][n]}), the schedule implies {lw} on wgmma")
        attn[kind] = {"launches_by_rank": launches, "max_abs_err": errs, "tol": tols}

    # The trainer under each rules table.
    train = {}
    for name, _, batch, seq, k1_per, split_by in par_runs(world):
        per_rank = [res["train"][name] for res in ranks]
        dims = per_rank[0]["model_dims"]
        hists = [pr["history"] for pr in per_rank]
        losses = [[h["loss"] for h in hist] for hist in hists]
        want_launch = k1_per * LAYERS * STEPS
        step_s = [sum(h["step_s"] for h in hist[1:]) / max(1, len(hist) - 1) for hist in hists]
        ref = single[name]
        loss_rel, norm_rel = deviation(hists, ref)
        staged = [sum(pr["staged_calls"].values()) for pr in per_rank]
        staged_b = [sum(pr["staged_bytes"].values()) for pr in per_rank]
        say(f"  {name} (B={batch}, T={seq}): losses {losses[0]}, grad_norms "
            f"{[h['grad_norm'] for h in hists[0]]}; one rank: losses "
            f"{[r['loss'] for r in ref]}, grad_norms {[r['grad_norm'] for r in ref]}; "
            f"worst step: loss rel {loss_rel:.3e} (tol {PAR_LOSS_REL}), grad_norm rel "
            f"{norm_rel:.3e} (tol {PAR_NORM_REL})")
        say(f"    backend {per_rank[0]['backend']}; step_s by rank "
            f"{[round(s, 4) for s in step_s]} (steps 2..{STEPS}); peak mem by rank "
            f"{[round(pr['peak_mem_gb'], 2) for pr in per_rank]} GB; held params "
            f"{[pr['held_bytes'] for pr in per_rank]} B; staged through host memory "
            f"{staged} call(s), {staged_b} B; collectives {per_rank[0]['calls']}")
        if any(len(ls) != STEPS or not all(math.isfinite(x) for x in ls) for ls in losses):
            fail(f"{name}: losses not finite or missing: {losses}")
        if any(ls != losses[0] for ls in losses):
            fail(f"{name}: ranks report different global losses {losses}")
        if loss_rel > PAR_LOSS_REL or norm_rel > PAR_NORM_REL:
            fail(f"{name}: differs from one rank: loss rel {loss_rel}, "
                 f"grad_norm rel {norm_rel}")
        for r, pr in enumerate(per_rank):
            for n, _ in KERNELS:
                if pr["launches"][n] != want_launch or pr["routes"][n]["wgmma"] != want_launch:
                    fail(f"{name}, rank {r}: {n} launched {pr['launches'][n]} "
                         f"({pr['routes'][n]}), want {want_launch} on wgmma")
        pieces: dict = {}
        for pr in per_rank:
            for leaf, piece, s1, s2 in pr["digests"]:
                pieces.setdefault((leaf, tuple(piece)), []).append((s1, s2))
        split = [key for key, seen in pieces.items() if len(set(seen)) > 1]
        replicas = sum(1 for seen in pieces.values() if len(seen) > 1)
        say(f"    replicas: {replicas} leaf pieces held by more than one rank, "
            f"{len(split)} differing after step {STEPS}")
        if split:
            fail(f"{name}: replicas differ across ranks after the last step: {split}")
        # The leaves held whole are the norms (and everything, unsplit);
        # a split leaf's bytes divide by its pieces.
        for r, pr in enumerate(per_rank):
            want_held = (pr["full_bytes"] - pr["whole_bytes"]) // split_by + pr["whole_bytes"]
            if pr["held_bytes"] != want_held:
                fail(f"{name}, rank {r}: holds {pr['held_bytes']} B of params, want "
                     f"{want_held} ({pr['full_bytes']} B unsharded, {pr['whole_bytes']} B "
                     "held whole)")
        # The heads each rank's attention took (recorded where the layer
        # calls the model's attention; the sequence-parallel runs call the
        # ring's instead).
        model = split_by if name == "tp_sp_model" else 1
        want_heads = [(dims["n_heads"] // model, dims["n_kv_heads"] // model)]
        if name in ("dp", "fsdp", "tp_sp_model") and any(pr["heads"] != want_heads
                                                          for pr in per_rank):
            fail(f"{name}: attention ran at (q, kv) heads {[pr['heads'] for pr in per_rank]}, "
                 f"want {want_heads} a rank")
        expected = None
        if name == "tp_sp_model":
            expected = tp_collectives(batch, seq, dims["dim"], dims["n_layers"], STEPS,
                                      dims["itemsize"])
            got = {k: {op: per_rank[0][k][op] for op in expected[k]} for k in expected}
            others = {op: n for op, n in per_rank[0]["calls"].items()
                      if op not in expected["calls"] and n}
            say(f"    collectives a rank: {got['calls']} calls, {got['bytes']} B; written "
                f"down beforehand {expected['calls']}, {expected['bytes']} B")
            if any(pr["calls"] != per_rank[0]["calls"] or pr["bytes"] != per_rank[0]["bytes"]
                   for pr in per_rank) or got != expected or others:
                fail(f"{name}: collectives {per_rank[0]['calls']} calls, "
                     f"{per_rank[0]['bytes']} B (by rank equal: "
                     f"{all(pr['calls'] == per_rank[0]['calls'] for pr in per_rank)}), "
                     f"want {expected}")
        train[name] = {
            "batch": batch, "seq": seq, "heads_by_rank": [pr["heads"] for pr in per_rank],
            "collectives_written_down": expected,
            "losses_by_rank": losses, "loss_rel": loss_rel, "grad_norm_rel": norm_rel,
            "step_s_by_rank": step_s,
            "peak_mem_gb_by_rank": [pr["peak_mem_gb"] for pr in per_rank],
            "held_bytes_by_rank": [pr["held_bytes"] for pr in per_rank],
            "unsharded_bytes": per_rank[0]["full_bytes"],
            "launches_by_rank": [{n: pr["launches"][n] for n, _ in KERNELS} for pr in per_rank],
            "staged_calls_by_rank": staged, "staged_bytes_by_rank": staged_b,
            "collective_calls": per_rank[0]["calls"], "collective_bytes": per_rank[0]["bytes"],
            "replica_pieces_checked": replicas, "backend": per_rank[0]["backend"],
        }
    # The planted faults: each must break a limit the sound runs keep.
    faults = {}
    for fault, run in PAR_FAULTS:
        hists = [res["faults"][fault] for res in ranks]
        loss_rel, norm_rel = deviation(hists, single[run])
        caught = loss_rel > PAR_LOSS_REL or norm_rel > PAR_NORM_REL
        say(f"  planted {fault} in {run}: losses by rank {[[h['loss'] for h in hist] for hist in hists]}, "
            f"grad_norms {[[h['grad_norm'] for h in hist] for hist in hists]}; worst step: loss rel "
            f"{loss_rel:.3e}, grad_norm rel {norm_rel:.3e}: "
            f"{'caught' if caught else 'NOT caught'}")
        if not caught:
            fail(f"planted fault {fault} in {run} stays within the limits: loss rel "
                 f"{loss_rel} (<= {PAR_LOSS_REL}), grad_norm rel {norm_rel} (<= {PAR_NORM_REL})")
        faults[fault] = {"run": run, "loss_rel": loss_rel, "grad_norm_rel": norm_rel}
    return {"attention": attn, "train": train, "faults": faults}


def slice12_references(device: str, moe_history: list | None, full: bool = True) -> dict:
    """One rank's history of each slice-12 run on its global batch and
    initial params: phase 11's for (a) (where ``moe_history`` is None, a
    run here), runs of the CLI here for (b) and (c) (with (c)'s BN running
    statistics after the last step)."""
    import gc

    import torch

    from oim_tpu_torch.cli import oim_trainer

    refs = {"ep": {"history": moe_history}} if moe_history is not None else {}
    steps = {"moe_drops": PAR_FAULT_STEPS, "resnet_dp": STEPS}
    for run in [r for r in ("ep", "moe_fsdp", "moe_drops", "resnet_dp")
                if r not in refs and (full or r in ("ep", "resnet_dp"))]:
        trainer = oim_trainer.run(slice12_argv(run, device, steps.get(run, MOE_STEPS)))
        refs[run] = {"history": trainer.history, "extra": _extra_host(trainer)}
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    return refs


def _resume_one_rank(run: str, ckpt: str, device: str) -> dict:
    """The CLI on one process resuming ``ckpt`` (step 2 of a meshed run) to
    step MOE_STEPS."""
    import gc

    import torch

    rec, trainer = _slice12_run(slice12_argv(run, device, MOE_STEPS)
                                + ["--checkpoint-dir", ckpt], device)
    del trainer
    shutil.rmtree(ckpt)
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _slice12_limits(run: str) -> tuple[float, float]:
    """(loss, grad_norm) relative limits of a slice-12 run against one rank."""
    if run == "resnet_dp":
        return RESNET_PAR_LOSS_REL, RESNET_PAR_NORM_REL
    return PAR_LOSS_REL, PAR_NORM_REL


def check_slice12(ranks: list, refs: dict, resumes: dict | None) -> tuple[dict, dict]:
    """The gates of (a)-(d) and SLICE12_FAULTS on every rank's results
    (with ``resumes`` None, of (a) and (c) alone)."""
    per = [r["slice12"] for r in ranks]
    world = len(ranks)
    mcfg = moe_flagship()
    out = {}
    for run, layers, route in (("ep", mcfg.n_layers, "wgmma"),
                               ("moe_fsdp", MOE_FSDP_LAYERS, "fma"), ("resnet_dp", 0, "fma")):
        if run not in per[0]:
            continue
        recs = [p[run] for p in per]
        hists = [r["history"] for r in recs]
        ref = refs[run]["history"]
        loss_rel, norm_rel = deviation(hists, ref)
        losses = [[h["loss"] for h in hist] for hist in hists]
        steps = len(ref)
        step_s = [sum(h["step_s"] for h in hist[1:]) / max(1, len(hist) - 1) for hist in hists]
        loss_tol, norm_tol = _slice12_limits(run)
        say(f"  {run}: losses {losses[0]}, grad_norms {[h['grad_norm'] for h in hists[0]]}; "
            f"one rank: losses {[r['loss'] for r in ref]}, grad_norms "
            f"{[r['grad_norm'] for r in ref]}; worst step: loss rel {loss_rel:.3e} (tol "
            f"{loss_tol}), grad_norm rel {norm_rel:.3e} (tol {norm_tol})")
        say(f"    step_s by rank {[round(x, 4) for x in step_s]} (steps 2..{steps}); peak mem "
            f"by rank {[round(r['peak_mem_gb'], 2) for r in recs]} GB; held params "
            f"{[r['held_bytes'] for r in recs]} B of {recs[0]['full_bytes']}; collectives "
            f"{recs[0]['calls']} calls, {recs[0]['bytes']} B; staged "
            f"{[sum(r['staged_calls'].values()) for r in recs]} call(s)")
        if any(len(ls) != steps or not all(math.isfinite(x) for x in ls) for ls in losses):
            fail(f"{run}: losses not finite or missing: {losses}")
        if any(ls != losses[0] for ls in losses):
            fail(f"{run}: ranks report different global losses {losses}")
        if loss_rel > loss_tol or norm_rel > norm_tol:
            fail(f"{run}: differs from one rank: loss rel {loss_rel}, grad_norm rel {norm_rel}")
        want = layers * steps
        for r, rec in enumerate(recs):
            for n, _ in KERNELS:
                if rec["launches"][n] != want or rec["routes"][n][route] != want:
                    fail(f"{run}, rank {r}: {n} launched {rec['launches'][n]} "
                         f"({rec['routes'][n]}), want {want} on {route}")
            want_held = (rec["full_bytes"] - rec["whole_bytes"]) // world + rec["whole_bytes"]
            if run != "resnet_dp" and rec["held_bytes"] != want_held:
                fail(f"{run}, rank {r}: holds {rec['held_bytes']} B, want {want_held}")
        pieces: dict = {}
        for rec in recs:
            for leaf, piece, s1, s2 in rec["digests"]:
                pieces.setdefault((leaf, tuple(piece)), []).append((s1, s2))
        differ = [key for key, seen in pieces.items() if len(set(seen)) > 1]
        replicas = sum(1 for seen in pieces.values() if len(seen) > 1)
        if differ:
            fail(f"{run}: replicas differ across ranks after the last step: {differ[:5]}")
        entry = {"losses_by_rank": losses, "loss_rel": loss_rel, "grad_norm_rel": norm_rel,
                 "step_s_by_rank": step_s,
                 "peak_mem_gb_by_rank": [r["peak_mem_gb"] for r in recs],
                 "held_bytes_by_rank": [r["held_bytes"] for r in recs],
                 "unsharded_bytes": recs[0]["full_bytes"],
                 "launches_by_rank": [{n: r["launches"][n] for n, _ in KERNELS} for r in recs],
                 "collective_calls": recs[0]["calls"], "collective_bytes": recs[0]["bytes"],
                 "replica_pieces_checked": replicas, "backend": recs[0]["backend"]}
        if run != "resnet_dp":
            drops = [[h["moe_drop_frac"] for h in hist] for hist in hists]
            ref_drops = [h["moe_drop_frac"] for h in ref]
            # One routing assignment of B x T x k is the least step of the share.
            unit = 1.0 / (BATCH * SEQ * mcfg.moe_top_k)
            worst = max(abs(a - b) for d in drops for a, b in zip(d, ref_drops))
            say(f"    moe_drop_frac {drops[0]} (one rank {ref_drops}; worst {worst:.3e}, "
                f"limit one assignment {unit:.3e})")
            if worst > unit:
                fail(f"{run}: moe_drop_frac {drops} against one rank's {ref_drops}")
            entry["moe_drop_frac_by_rank"], entry["moe_drop_frac_one_rank"] = drops, ref_drops
        if run == "ep":
            expected = ep_collectives(BATCH * SEQ, mcfg.dim, mcfg.n_layers,
                                      mcfg.n_experts // world, mcfg.moe_top_k, steps,
                                      resumes is not None, mcfg.dtype.itemsize)
            got = {k: {op: recs[0][k][op] for op in expected[k]} for k in expected}
            others = {op: n for op, n in recs[0]["calls"].items()
                      if op not in expected["calls"] and n}
            say(f"    collectives a rank: {got['calls']} calls, {got['bytes']} B; written "
                f"down beforehand {expected['calls']}, {expected['bytes']} B")
            if any(r["calls"] != recs[0]["calls"] or r["bytes"] != recs[0]["bytes"]
                   for r in recs) or got != expected or others:
                fail(f"ep: collectives {recs[0]['calls']} calls, {recs[0]['bytes']} B, "
                     f"want {expected}")
            entry["collectives_written_down"] = expected
        if run == "resnet_dp":
            ref_extra = refs[run]["extra"]
            for r, rec in enumerate(recs):
                if any(not np.array_equal(rec["extra"][k], recs[0]["extra"][k])
                       for k in ref_extra):
                    fail(f"resnet_dp, rank {r}: BN running statistics differ across ranks")
            rel = max(float(np.abs(recs[0]["extra"][k] - v).max() / max(np.abs(v).max(), 1e-30))
                      for k, v in ref_extra.items())
            say(f"    BN running statistics after step {steps} against one rank's: worst leaf "
                f"max|diff|/max|ref| {rel:.3e} (tol {RESNET_BN_REL:.3e}); equal on both ranks")
            if rel > RESNET_BN_REL:
                fail(f"resnet_dp: BN running statistics {rel} from one rank's")
            entry["bn_stats_rel"] = rel
        out[run] = entry
    if resumes is None:
        return out, {}

    # (d) checkpoints: (i) the same mesh resumes bitwise; (ii) one rank
    # within the limits; save and restore seconds and bytes.
    same = [p["resume_same"] for p in per]
    first = [p["moe_fsdp"] for p in per]
    for r, (a, b) in enumerate(zip(same, first)):
        got = [(h["step"], h["loss"], h["grad_norm"]) for h in a["history"]]
        want = [(h["step"], h["loss"], h["grad_norm"]) for h in b["history"][2:]]
        say(f"  (d)(i) rank {r} resumed at step 2 on the same mesh: {got}; unbroken {want}; "
            f"restore {a['restore_s']} s")
        if got != want or a["digests"] != b["digests"]:
            fail(f"(d)(i) rank {r}: the resumed steps or final params are not the unbroken "
                 f"run's to the bit: {got} against {want}")
    ckpt = [p["moe_fsdp"]["checkpoint"] for p in per]
    say(f"  (d) save of the 2-layer flagship under fsdp=2: seconds by rank "
        f"{[round(c['save_s'], 3) for c in ckpt]}, piece bytes by rank "
        f"{[c['piece_bytes'] for c in ckpt]}")
    out["checkpoint"] = {"save_s_by_rank": [c["save_s"] for c in ckpt],
                         "piece_bytes_by_rank": [c["piece_bytes"] for c in ckpt],
                         "restore_s_same_mesh_by_rank": [a["restore_s"] for a in same]}
    for run, rec in resumes.items():
        ref = refs[run]["history"][2:]
        loss_rel, norm_rel = deviation([rec["history"]], ref)
        steps = [h["step"] for h in rec["history"]]
        say(f"  (d)(ii) {run} resumed on one rank at step 2: steps {steps}, losses "
            f"{[h['loss'] for h in rec['history']]}; loss rel {loss_rel:.3e}, grad_norm rel "
            f"{norm_rel:.3e}; restore {rec['restore_s']} s")
        if steps != [3, 4] or loss_rel > PAR_LOSS_REL or norm_rel > PAR_NORM_REL:
            fail(f"(d)(ii) {run} on one rank: steps {steps}, loss rel {loss_rel}, "
                 f"grad_norm rel {norm_rel}")
        out["checkpoint"][f"resume_one_rank_{run}"] = {"loss_rel": loss_rel,
                                                       "grad_norm_rel": norm_rel,
                                                       "restore_s": rec["restore_s"]}
    faults = {}
    for fault, run in SLICE12_FAULTS:
        hists = [p["faults"][fault] for p in per]
        loss_rel, norm_rel = deviation(hists, refs[run]["history"])
        loss_tol, norm_tol = _slice12_limits(run)
        caught = loss_rel > loss_tol or norm_rel > norm_tol
        say(f"  planted {fault} in {run}: losses {[h['loss'] for h in hists[0]]}; worst step: "
            f"loss rel {loss_rel:.3e}, grad_norm rel {norm_rel:.3e}: "
            f"{'caught' if caught else 'NOT caught'}")
        if not caught:
            fail(f"planted fault {fault} in {run} stays within the limits: loss rel "
                 f"{loss_rel}, grad_norm rel {norm_rel}")
        faults[fault] = {"run": run, "loss_rel": loss_rel, "grad_norm_rel": norm_rel}
    return out, faults


# Phase 15, pipeline parallelism (two ranks over pipe=2): (e) GPipe, (f)
# 1F1B and (g) interleaved 1F1B (v=2, one layer a chunk) at llama3-8b
# width, depth cut to PIPE_LAYERS (2 a stage), B=PIPE_BATCH, M=PIPE_M, bf16,
# STEPS steps, each against the port's one-rank run of the same
# configuration (rules dp); (h) the MoE flagship (8 layers, 4 a stage)
# under 1F1B at B=2, M=2 against one rank under rules pipe over pipe=1 at
# the same M (MoE capacity is per microbatch). One step's peak memory a
# rank at M=PIPE_M and M=PIPE_M_WIDE (B=M, one row a microbatch) shows
# the memory law: GPipe keeps M microbatches' graphs, 1F1B its in-flight
# window. On four cards (chip_multigpu.py): pipe=4 under GPipe and 1F1B,
# and data=2,pipe=2 under 1F1B.
PIPE_LAYERS, PIPE_BATCH, PIPE_M, PIPE_M_WIDE = 4, 4, 4, 8
# (name, schedule, virtual stages, mesh, global batch, microbatches, layers)
MOE_PIPE = ("moe_1f1b", "1f1b", 1, "data=1,pipe=2", BATCH, 2, 8)
# (h) runs in float32 (SLICE12_DTYPE; K1-K3 then take their fma route). In
# bf16 each rank's cotangent of the head's input (its vocabulary half's
# share of dy) is rounded before the sum over pipe, where one rank rounds
# the whole vocabulary's dy once; after the first update that last bit
# flips MoE routes (bf16 on one H100: loss rel 2.66e-4, grad_norm rel
# 2.05e-3 and the drop share 8.1e-4 off at steps 3-4, steps 1-2 equal).
PIPE_F32 = ("moe_1f1b",)
# Faults planted in the pipe runs, which their limits must catch: the
# interleaved run on the canonical layer order (no permutation: each chunk
# runs another global stage's layers), and the MoE aux counted on idle
# ticks as well (an executor that runs its stage on every tick, as JAX's
# unconditional mode does, without masking the idle ones: each stage's
# aux then counts n_ticks / (v M) times).
PIPE_FAULTS = (("canonical_order", "1f1b_v2"), ("aux_idle_ticks", "moe_1f1b"))


def pipe_runs(world: int) -> tuple:
    """The dense pipe runs on ``world`` ranks (rows as MOE_PIPE's)."""
    if world == 2:
        mesh = "data=1,pipe=2"
        return (("gpipe", "gpipe", 1, mesh, PIPE_BATCH, PIPE_M, PIPE_LAYERS),
                ("1f1b", "1f1b", 1, mesh, PIPE_BATCH, PIPE_M, PIPE_LAYERS),
                ("1f1b_v2", "1f1b", 2, mesh, PIPE_BATCH, PIPE_M, PIPE_LAYERS))
    layers = max(PIPE_LAYERS, world)
    runs = [(f"gpipe_p{world}", "gpipe", 1, f"data=1,pipe={world}", world, world, layers),
            (f"1f1b_p{world}", "1f1b", 1, f"data=1,pipe={world}", world, world, layers)]
    if world == 4:
        runs.append(("dp2_1f1b", "1f1b", 1, "data=2,pipe=2", PIPE_BATCH, 2, PIPE_LAYERS))
    return tuple(runs)


def pipe_argv(run: tuple, device: str, steps: int = STEPS, world: int = 0,
              microbatches: int = 0) -> list:
    """``run`` on ``world`` ranks, at ``microbatches`` (and as many rows)
    where given; 0 ranks is its one-rank reference: rules dp for a dense
    run, rules pipe over pipe=1 at the same M for the MoE one."""
    name, schedule, v, mesh, batch, m, layers = run
    moe = name.startswith("moe")
    base = moe_argv() if moe else main_path_argv() + ["--override", f"n_layers={layers}"]
    if name in PIPE_F32:
        base += SLICE12_DTYPE
    if microbatches:
        batch = m = microbatches
    flags = []
    if world or moe:
        flags = ["--rules", "pipe", "--mesh", mesh if world else "data=1,pipe=1",
                 "--microbatches", str(m), "--pipeline-schedule", schedule,
                 "--virtual-stages", str(v)]
    return base + flags + ["--batch-size", str(batch), "--seq-len", str(SEQ), "--steps",
                           str(steps), "--device", device, "--log-level", "warning"]


def _step_peaks(peaks: list, device: str):
    """A ``patched`` context recording each train step's device memory into
    ``peaks``: (allocated at its start, its peak), GB, this process's
    allocator."""
    import torch

    from oim_tpu_torch.train import trainer as T

    def wrap(make_train_step):
        def made(*a, **k):
            step_fn, *rest = make_train_step(*a, **k)

            def step(state, batch):
                _sync(device)
                torch.cuda.reset_peak_memory_stats(device)
                start = torch.cuda.memory_allocated(device) / 1e9
                out = step_fn(state, batch)
                _sync(device)
                peaks.append((start, torch.cuda.max_memory_allocated(device) / 1e9))
                return out
            return (step, *rest)
        return made
    return patched(T, "make_train_step", wrap)


def planted_pipe(fault: str):
    """A ``patched`` context planting ``fault`` (of PIPE_FAULTS)."""
    from oim_tpu_torch.parallel import pipeline_1f1b as P1

    if fault == "canonical_order":
        def canonical(n_layers, p, v):
            order = np.arange(n_layers, dtype=np.int32)
            return order, order
        return patched(P1, "interleave_layer_permutation", lambda _: canonical)
    sched = P1.simulate_1f1b(2, MOE_PIPE[5])
    factor = sched.n_ticks / (sched.v * sched.m)
    return patched(P1, "add_aux", lambda add: lambda total, aux: add(
        total, None if aux is None else aux * factor))


def _pipe_run(argv: list, device: str) -> dict:
    """``_slice12_run``'s record of one pipe run, with each step's peak
    memory and the 1F1B executor's stash peaks of the last step."""
    import torch

    from oim_tpu_torch.parallel import pipeline_1f1b as P1

    peaks: list = []
    P1.STASH_PEAK.update(x=0, dh=0)
    with _step_peaks(peaks, device) if torch.device(device).type == "cuda" \
            else contextlib.nullcontext():
        rec, trainer = _slice12_run(argv, device)
    del trainer
    rec["step_start_gb"] = [a for a, _ in peaks]
    rec["step_peak_gb"] = [b for _, b in peaks]
    rec["stash_peak"] = dict(P1.STASH_PEAK)
    return rec


def pipe_job(rank: int, world: int, device: str, full: bool = True) -> dict:
    """The pipe runs on this rank: ``pipe_runs(world)``, and with ``full``
    (h), the memory readings at M=PIPE_M_WIDE and PIPE_FAULTS."""
    runs = pipe_runs(world) + ((MOE_PIPE,) if full else ())
    out = {run[0]: _pipe_run(pipe_argv(run, device, world=world), device) for run in runs}
    if full:
        by = {run[0]: run for run in runs}
        recs = {f"{name}_m{PIPE_M}": out[name] for name in ("gpipe", "1f1b")}
        for name in ("gpipe", "1f1b"):
            recs[f"{name}_m{PIPE_M_WIDE}"] = _pipe_run(
                pipe_argv(by[name], device, 2, world, PIPE_M_WIDE), device)
        out["memory"] = {k: {"start_gb": r["step_start_gb"], "peak_gb": r["step_peak_gb"]}
                         for k, r in recs.items()}
        faults = {}
        for fault, run in PIPE_FAULTS:
            with planted_pipe(fault):
                faults[fault] = _pipe_run(pipe_argv(by[run], device, PAR_FAULT_STEPS, world),
                                          device)["history"]
        out["faults"] = faults
    return out


def pipe_references(device: str, world: int, full: bool = True) -> dict:
    """One process's history of each pipe run's reference (``pipe_argv``
    with no ranks): one dense run serves every dense pipe run (the same
    global batch, layers and initial params)."""
    import gc

    import torch

    from oim_tpu_torch.cli import oim_trainer

    refs, seen = {}, {}
    for run in pipe_runs(world) + ((MOE_PIPE,) if full else ()):
        argv = pipe_argv(run, device)
        key = tuple(argv)
        if key not in seen:
            seen[key] = oim_trainer.run(argv).history
            gc.collect()
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
        refs[run[0]] = seen[key]
    return refs


def check_pipe(ranks: list, refs: dict, world: int) -> tuple[dict, dict, dict]:
    """The gates of the pipe runs on every rank's results: each run within
    PAR_LOSS_REL / PAR_NORM_REL of its reference at every step (the MoE
    run's drop share within one assignment), the same global losses on
    every rank, K1-K3 launches a rank at the schedule's count on wgmma, the
    1F1B stash peaks at the schedule's, replicas equal to the bit and half
    the split leaves a rank; the memory readings; PIPE_FAULTS caught.
    Returns (runs, faults, memory)."""
    from oim_tpu_torch.parallel.pipeline_1f1b import simulate_1f1b

    per = [r["pipe"] for r in ranks]
    out = {}
    runs = pipe_runs(world) + ((MOE_PIPE,) if MOE_PIPE[0] in per[0] else ())
    for name, schedule, v, mesh, batch, m, layers in runs:
        recs = [p[name] for p in per]
        hists = [r["history"] for r in recs]
        ref = refs[name]
        loss_rel, norm_rel = deviation(hists, ref)
        losses = [[h["loss"] for h in hist] for hist in hists]
        p = dict(kv.split("=") for kv in mesh.split(","))
        stages = int(p["pipe"])
        k23 = layers // stages * m * STEPS
        want = {"flash_fwd": k23 * (2 if schedule == "1f1b" else 1), "flash_bwd_dkv": k23,
                "flash_bwd_dq": k23}
        route = "fma" if name in PIPE_F32 else "wgmma"
        step_s = [sum(h["step_s"] for h in hist[1:]) / max(1, len(hist) - 1) for hist in hists]
        say(f"  pipe {name} ({schedule}, v={v}, {mesh}, B={batch}, M={m}, {layers} layers): "
            f"losses {losses[0]}, grad_norms {[h['grad_norm'] for h in hists[0]]}; one rank: "
            f"losses {[r['loss'] for r in ref]}, grad_norms {[r['grad_norm'] for r in ref]}; "
            f"worst step: loss rel {loss_rel:.3e} (tol {PAR_LOSS_REL}), grad_norm rel "
            f"{norm_rel:.3e} (tol {PAR_NORM_REL})")
        say(f"    step_s by rank {[round(x, 4) for x in step_s]} (steps 2..{STEPS}); step peak "
            f"mem by rank {[[round(g, 2) for g in r['step_peak_gb']] for r in recs]} GB; held "
            f"params {[r['held_bytes'] for r in recs]} B of {recs[0]['full_bytes']}; stash "
            f"peaks {[r['stash_peak'] for r in recs]}; collectives {recs[0]['calls']} calls, "
            f"{recs[0]['bytes']} B; staged {[sum(r['staged_calls'].values()) for r in recs]} "
            f"call(s); launches {[{n: r['launches'][n] for n, _ in KERNELS} for r in recs]} "
            f"(want {want} a rank on {route})")
        if any(len(ls) != len(ref) or not all(math.isfinite(x) for x in ls) for ls in losses):
            fail(f"pipe {name}: losses not finite or missing: {losses}")
        if any(ls != losses[0] for ls in losses):
            fail(f"pipe {name}: ranks report different global losses {losses}")
        if loss_rel > PAR_LOSS_REL or norm_rel > PAR_NORM_REL:
            fail(f"pipe {name}: differs from one rank: loss rel {loss_rel}, "
                 f"grad_norm rel {norm_rel}")
        for r, rec in enumerate(recs):
            for n, _ in KERNELS:
                if rec["launches"][n] != want[n] or rec["routes"][n][route] != want[n]:
                    fail(f"pipe {name}, rank {r}: {n} launched {rec['launches'][n]} "
                         f"({rec['routes'][n]}), the schedule implies {want[n]} on {route}")
            want_held = (rec["full_bytes"] - rec["whole_bytes"]) // stages + rec["whole_bytes"]
            if rec["held_bytes"] != want_held:
                fail(f"pipe {name}, rank {r}: holds {rec['held_bytes']} B, want {want_held}")
        entry = {"schedule": schedule, "virtual_stages": v, "mesh": mesh, "batch": batch,
                 "microbatches": m, "layers": layers, "losses_by_rank": losses,
                 "loss_rel": loss_rel, "grad_norm_rel": norm_rel, "step_s_by_rank": step_s,
                 "step_start_gb_by_rank": [r["step_start_gb"] for r in recs],
                 "step_peak_gb_by_rank": [r["step_peak_gb"] for r in recs],
                 "peak_mem_gb_by_rank": [r["peak_mem_gb"] for r in recs],
                 "held_bytes_by_rank": [r["held_bytes"] for r in recs],
                 "unsharded_bytes": recs[0]["full_bytes"],
                 "launches_by_rank": [{n: r["launches"][n] for n, _ in KERNELS} for r in recs],
                 "launches_want": want, "route": route, "collective_calls": recs[0]["calls"],
                 "collective_bytes": recs[0]["bytes"],
                 "staged_calls_by_rank": [sum(r["staged_calls"].values()) for r in recs],
                 "backend": recs[0]["backend"]}
        if schedule == "1f1b":
            sched = simulate_1f1b(stages, m, v)
            peak_x = max(r["stash_peak"]["x"] for r in recs)
            peak_dh = max(r["stash_peak"]["dh"] for r in recs)
            say(f"    stash: peak {peak_x} inputs, {peak_dh} cotangents of a chunk; the schedule's "
                f"stash_x {sched.stash_x}, stash_dh {sched.stash_dh}")
            if peak_x > sched.stash_x or peak_dh > sched.stash_dh or (
                    v == 1 and peak_x != sched.stash_x):
                fail(f"pipe {name}: stash peaks {peak_x}, {peak_dh} against the schedule's "
                     f"{sched.stash_x}, {sched.stash_dh}")
            entry["stash_peak"], entry["stash_x"] = [peak_x, peak_dh], sched.stash_x
        pieces: dict = {}
        for rec in recs:
            for leaf, piece, s1, s2 in rec["digests"]:
                pieces.setdefault((leaf, tuple(piece)), []).append((s1, s2))
        differ = [key for key, seen in pieces.items() if len(set(seen)) > 1]
        entry["replica_pieces_checked"] = sum(1 for seen in pieces.values() if len(seen) > 1)
        if differ:
            fail(f"pipe {name}: replicas differ across ranks after the last step: {differ[:5]}")
        if name.startswith("moe"):
            drops = [[h["moe_drop_frac"] for h in hist] for hist in hists]
            ref_drops = [h["moe_drop_frac"] for h in ref]
            unit = 1.0 / (batch * SEQ * moe_flagship().moe_top_k)
            worst = max(abs(a - b) for d in drops for a, b in zip(d, ref_drops))
            say(f"    moe_drop_frac {drops[0]} (one rank {ref_drops}; worst {worst:.3e}, "
                f"limit one assignment {unit:.3e})")
            if worst > unit:
                fail(f"pipe {name}: moe_drop_frac {drops} against one rank's {ref_drops}")
            entry["moe_drop_frac_by_rank"], entry["moe_drop_frac_one_rank"] = drops, ref_drops
        out[f"pipe_{name}"] = entry
    if "memory" not in per[0]:
        return out, {}, {}
    memory = {k: [p["memory"][k] for p in per] for k in per[0]["memory"]}
    for k, v in memory.items():
        steps = [[(round(a, 2), round(b, 2)) for a, b in zip(r["start_gb"], r["peak_gb"])]
                 for r in v]
        say(f"  pipe memory law, {k}: each step's (allocated at its start, peak) GB by rank "
            f"{steps}")
    faults = {}
    for fault, run in PIPE_FAULTS:
        hists = [p["faults"][fault] for p in per]
        loss_rel, norm_rel = deviation(hists, refs[run])
        drop = max((abs(h["moe_drop_frac"] - r["moe_drop_frac"])
                    for hist in hists for h, r in zip(hist, refs[run]) if "moe_drop_frac" in h),
                   default=0.0)
        caught = loss_rel > PAR_LOSS_REL or norm_rel > PAR_NORM_REL
        say(f"  planted {fault} in pipe {run}: losses {[h['loss'] for h in hists[0]]}; worst "
            f"step: loss rel {loss_rel:.3e}, grad_norm rel {norm_rel:.3e}, moe_drop_frac "
            f"|diff| {drop:.3e}: {'caught' if caught else 'NOT caught'}")
        if not caught:
            fail(f"planted fault {fault} in pipe {run} stays within the limits: loss rel "
                 f"{loss_rel}, grad_norm rel {norm_rel}")
        faults[fault] = {"run": f"pipe_{run}", "loss_rel": loss_rel, "grad_norm_rel": norm_rel,
                         "moe_drop_frac_diff": drop}
    return out, faults, memory


# Phase 15, slice 14: (i) one token volume staged across the data=2 mesh,
# each rank its slice, consumed in place by the llama3-8b-width dp step;
# (j) a model axis that splits a query head. Both ranks share the card
# over gloo: no multi-GPU speed is measured.
#
# (i): an int32 .npy laid out [PLACE_N, BATCH, SEQ + 1], staged with
# sharding_axes ["", "data", ""]: each rank reads PLACE_N runs of SEQ + 1
# tokens, the most runs a slice may have (plane.MAX_RUNS), 0.54 GB a rank
# of a 1.07 GB file. Its first STEPS batches are phase 5's synthetic
# ones, so phase 5's history is the one-rank reference on vol[i]; the
# rest are seeded. The same layout at PLACE_FALLBACK_N batches exceeds
# MAX_RUNS and must take the whole-read fallback.
PLACE_N = 65_536
PLACE_FALLBACK_N = 2 * PLACE_N
PLACE_BLOCK = 4096            # batches written and compared at a time
PLACE_CACHE = 4 << 30         # stage-cache bytes of a rank's backend
# (j): no published config the repo holds has a head count that 2 ranks
# split, so llama-tiny's 2 layers with 3 query heads of 128 and 1 KV head
# (K1-K3 on wgmma in bf16), one row of HEADSPLIT_T tokens, widened to dim
# 1024, mlp 3584 and a 32768 vocabulary: at llama-tiny's dim 64 and
# vocabulary 256 the split's bf16 roundings alone (a rank's wo partial and
# the q cotangent summed after rounding) move grad_norm by 8e-4 to 1.4e-3
# of one rank's (CPU rehearsal at T 512-2048), past PAR_NORM_REL; at these
# widths by 1.1e-4 (CPU, T 4096), the planted fault by 1.9e-2.
HEADSPLIT_T = 4096
HEADSPLIT_MODEL = ["--model", "llama-tiny"] + [
    a for kv in ("n_heads=3", "n_kv_heads=1", "head_dim=128", "dim=1024", "mlp_dim=3584",
                 "vocab=32768", "dtype=bfloat16") for a in ("--override", kv)]
HEADSPLIT_FLAGS = ["--rules", "tp_sp", "--mesh", f"data=1,fsdp=1,seq=1,model={PAR_WORLD}"]


def write_placed_volume(path: str, n: int, seed: int) -> int:
    """An int32 .npy [n, BATCH, SEQ + 1]: phase 5's first STEPS synthetic
    batches, then seeded tokens, written PLACE_BLOCK batches at a time and
    synced; returns its payload offset."""
    from oim_tpu_torch.cli import oim_trainer
    from oim_tpu_torch.train.trainer import synthetic_batches

    cfg = oim_trainer.config_from_args(oim_trainer.parse_args(main_path_argv()))
    first = [b["tokens"] for _, b in zip(range(STEPS), synthetic_batches(cfg))]
    vocab = cfg.model_config().vocab
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<i4", "fortran_order": False, "shape": (n, BATCH, SEQ + 1)})
        payload = f.tell()
        np.stack(first).astype(np.int32).tofile(f)
        for a in range(STEPS, n, PLACE_BLOCK):
            rng.integers(0, vocab, (min(PLACE_BLOCK, n - a), BATCH, SEQ + 1),
                         dtype=np.int32).tofile(f)
        f.flush()
        os.fsync(f.fileno())
    return payload


def _slice_equal(local, path: str, rank: int) -> bool:
    """This rank's staged [n, 1, SEQ + 1] against its rows of the file, on
    the card, block by block."""
    import torch

    mm = np.load(path, mmap_mode="r")
    if tuple(local.shape) != (mm.shape[0], 1, mm.shape[2]) or local.dtype != torch.int32:
        return False
    for a in range(0, mm.shape[0], PLACE_BLOCK):
        want = torch.from_numpy(np.ascontiguousarray(mm[a:a + PLACE_BLOCK, rank:rank + 1]))
        if not torch.equal(local[a:a + PLACE_BLOCK], want.to(local.device)):
            return False
    return True


def _stage_placed(backend, volume_id: str, path: str) -> tuple:
    """(volume, seconds, oim_staged_bytes_total delta, stage_source calls)
    of one stage of ``path`` with sharding_axes ["", "data", ""]."""
    from oim_tpu_torch.common import metrics as M
    from oim_tpu_torch.controller import StagedVolume
    from oim_tpu_torch.data import plane
    from oim_tpu_torch.spec import ArraySpec, FileParams

    vol = StagedVolume(volume_id, b"", ArraySpec(sharding_axes=("", "data", "")))
    b0, calls, t0 = M.STAGED_BYTES.value, plane.STAGE_CALLS, time.monotonic()
    backend.stage(vol, "file", FileParams(path, "npy"))
    vol.wait()
    return (vol, time.monotonic() - t0, M.STAGED_BYTES.value - b0,
            plane.STAGE_CALLS - calls)


def _runs_read(reads: list) -> int:
    """Runs of a file read as (offset, length) pieces: a run split over two
    chunks is read in two contiguous pieces, which count once."""
    runs, end = 0, None
    for off, n in sorted(reads):
        runs += off != end
        end = off + n
    return runs


def placement_job(rank: int, world: int, device: str, paths: dict) -> dict:
    """(i) on this rank: the stage of the volume through its own
    CUDABackend(mesh=...) with its byte, memory, cache and read checks; the
    dp trainer fed the placed batches; the fallback stage past MAX_RUNS."""
    import gc

    import torch

    from oim_tpu_torch import kernels
    from oim_tpu_torch.cli import oim_trainer
    from oim_tpu_torch.controller import CUDABackend, StageState
    from oim_tpu_torch.data import plane
    from oim_tpu_torch.parallel.mesh import build_mesh
    from oim_tpu_torch.train.trainer import Trainer

    mesh = build_mesh([("data", world)], device=device)
    backend = CUDABackend(device=device, mesh=mesh, cache_bytes=PLACE_CACHE,
                          chunk_bytes=FED_CHUNK)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.max_memory_allocated(device)
    reads = []  # (offset, length) of each file read the stage makes
    file_reader = plane.READERS["file"]

    def counted(locator, offset, length, dst, headers, **kw):
        reads.append((offset, length))
        file_reader(locator, offset, length, dst, headers, **kw)

    plane.READERS["file"] = counted
    try:
        vol, stage_s, staged, calls = _stage_placed(backend, "placed", paths["lowered"])
    finally:
        plane.READERS["file"] = file_reader
    if vol.state != StageState.READY:
        raise RuntimeError(f"the placed stage ended {vol.state}: {vol.error}")
    growth = torch.cuda.max_memory_allocated(device) - before
    placed = vol.array
    shape = (PLACE_N, BATCH, SEQ + 1)
    rank_bytes = plane.placement_bytes(shape, torch.int32,
                                       plane.Placement.of(mesh, ("", "data", "")))
    out = {"stage_s": stage_s, "stage_gbps": rank_bytes / stage_s / 1e9,
           "breakdown": dict(plane.LAST_STAGE_BREAKDOWN), "staged_bytes": staged,
           "plane_calls": calls, "placement_bytes": rank_bytes,
           "volume_total_bytes": vol.total_bytes, "device_growth_bytes": growth,
           "is_placed": isinstance(placed, plane.Placed),
           "coords": [list(c) for c, _, _ in placed.shards],
           "runs": _runs_read(reads), "bytes_read": sum(n for _, n in reads)}
    out["slice_equal"] = _slice_equal(placed.local, paths["lowered"], rank)
    # restage after unstage: the cache's copy, no read
    ptr = placed.local.data_ptr()
    backend.unstage(vol)
    hit, out["cache_hit_s"], out["cache_hit_staged"], out["cache_hit_calls"] = _stage_placed(
        backend, "placed", paths["lowered"])
    out["cache_hit_same_storage"] = (hit.state == StageState.READY
                                     and hit.array.local.data_ptr() == ptr)
    # the dp trainer on the placed batches, through place_batch
    cfg = oim_trainer.config_from_args(oim_trainer.parse_args(
        run_argv(["--rules", "dp", "--mesh", f"data={world}"], BATCH, SEQ, device)))
    trainer = Trainer(cfg, device=device, mesh=mesh)
    untouched = []
    place = trainer.place_batch

    def checked(batch):
        got = place(batch)
        untouched.append(got["tokens"].data_ptr() == batch["tokens"].local.data_ptr())
        return got

    trainer.place_batch = checked
    placed = hit.array
    kernels.reset_launches()
    trainer.run(steps=STEPS, data=({"tokens": placed[i]} for i in range(PLACE_N)))
    _sync(device)
    out.update(history=trainer.history, untouched=untouched,
               launches=dict(kernels.LAUNCHES),
               routes={n: dict(r) for n, r in kernels.ROUTES.items()},
               step_s=[h["step_s"] for h in trainer.history])
    del trainer, placed
    backend.unstage(hit)
    backend.cache.evict_idle()
    hit = None
    gc.collect()
    torch.cuda.empty_cache()
    # past MAX_RUNS: the whole-read fallback, every addressable slice placed
    other = CUDABackend(device=device, mesh=mesh, chunk_bytes=FED_CHUNK, keep_cached=False)
    fb, fb_s, _, fb_calls = _stage_placed(other, "fallback", paths["fallback"])
    out["fallback"] = {
        "state": str(fb.state), "error": fb.error, "seconds": fb_s, "plane_calls": fb_calls,
        "is_placed": isinstance(fb.array, plane.Placed),
        "slice_equal": fb.array is not None and _slice_equal(fb.array.local,
                                                             paths["fallback"], rank),
        "bytes": fb.array.nbytes if fb.array is not None else 0}
    other.unstage(fb)
    return out


def headsplit_argv(device: str, steps: int = STEPS, ranks: bool = True) -> list:
    return (HEADSPLIT_MODEL + (HEADSPLIT_FLAGS if ranks else [])
            + ["--batch-size", "1", "--seq-len", str(HEADSPLIT_T), "--steps", str(steps),
               "--warmup-steps", "2", "--log-every", "1", "--device", device,
               "--log-level", "warning"])


def headsplit_job(rank: int, world: int, device: str) -> dict:
    """(j) on this rank: the head-splitting tensor-parallel run with its
    launches, the heads its attention took and its digests; then the
    planted ``gather_from`` for PAR_FAULT_STEPS steps."""
    from oim_tpu_torch import kernels
    from oim_tpu_torch.cli import oim_trainer
    from oim_tpu_torch.models import llama
    from oim_tpu_torch.parallel import collectives as C

    heads: set = set()

    def wrap(attention):
        def seen(q, k, v, **kw):
            heads.add((q.shape[2], k.shape[2]))
            return attention(q, k, v, **kw)
        return seen

    kernels.reset_launches()
    C.reset_counts()
    with patched(llama, "default_attention", wrap):
        trainer = oim_trainer.run(headsplit_argv(device))
    _sync(device)
    held, full, whole = _held_bytes(trainer)
    out = {"history": trainer.history, "launches": dict(kernels.LAUNCHES),
           "routes": {n: dict(r) for n, r in kernels.ROUTES.items()},
           "heads": sorted(heads), "calls": dict(C.CALLS), "digests": _digests(trainer),
           "held_bytes": held, "full_bytes": full, "whole_bytes": whole}
    del trainer
    with patched(llama, "_gather_heads",
                 lambda _: lambda q, tp: C.gather_from(q, tp, gather_dim=2)):
        out["fault"] = oim_trainer.run(headsplit_argv(device, PAR_FAULT_STEPS)).history
    return out


def slice14_job(rank: int, world: int, device: str, paths: dict) -> dict:
    return {"placement": placement_job(rank, world, device, paths),
            "headsplit": headsplit_job(rank, world, device)}


def slice14_volumes(root: str) -> dict:
    """The (i) volumes under ``root``: {"lowered", "fallback"} -> path,
    with the seconds their writing took."""
    t0 = time.monotonic()
    paths = {"lowered": os.path.join(root, "placed.npy"),
             "fallback": os.path.join(root, "placed_fallback.npy")}
    free = shutil.disk_usage(root).free
    need = (PLACE_N + PLACE_FALLBACK_N) * BATCH * (SEQ + 1) * 4
    if free < need + (1 << 30):
        fail(f"(i): {free / 2**30:.1f} GiB free at {root}, the volumes need "
             f"{need / 2**30:.1f} GiB (+1)")
    write_placed_volume(paths["lowered"], PLACE_N, 140)
    write_placed_volume(paths["fallback"], PLACE_FALLBACK_N, 141)
    say(f"  (i) wrote [{PLACE_N}, {BATCH}, {SEQ + 1}] and [{PLACE_FALLBACK_N}, {BATCH}, "
        f"{SEQ + 1}] int32 .npy volumes ({os.path.getsize(paths['lowered']) / 1e9:.2f} and "
        f"{os.path.getsize(paths['fallback']) / 1e9:.2f} GB) in "
        f"{time.monotonic() - t0:.1f} s")
    return paths


def slice14_references(device: str) -> dict:
    """(j)'s one-rank history on its batch and initial params ((i)'s is
    phase 5's)."""
    import gc

    import torch

    from oim_tpu_torch.cli import oim_trainer

    hist = oim_trainer.run(headsplit_argv(device, ranks=False)).history
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"headsplit": hist}


def check_slice14(ranks: list, main: dict, refs: dict, stage8: dict) -> tuple[dict, dict]:
    """The gates of (i) and (j) on every rank's results; returns (train
    records for the parallel line, the planted fault's record)."""
    rank_bytes = PLACE_N * (SEQ + 1) * 4  # one row of every batch
    per_rank = [res["slice14"]["placement"] for res in ranks]
    for r, pr in enumerate(per_rank):
        bd = pr["breakdown"]
        say(f"  (i) rank {r}: staged {pr['placement_bytes']} B of [{PLACE_N}, {BATCH}, "
            f"{SEQ + 1}] int32 ({pr['runs']} runs of {(SEQ + 1) * 4} B) in "
            f"{pr['stage_s']:.3f} s, {pr['stage_gbps']:.2f} GB/s; breakdown disk_s "
            f"{bd['disk_s']:.3f}, h2d_s {bd['h2d_s']:.3f}, dispatch_s {bd['dispatch_s']:.3f} "
            f"(phase 8's one-device stage: {stage8['stage_gbps']:.2f} GB/s, "
            f"{stage8['stage_s']:.3f} s for {stage8['volume_bytes']} B); "
            f"oim_staged_bytes_total +{pr['staged_bytes']:.0f}; device growth "
            f"{pr['device_growth_bytes']} B (limit slice + 2 chunks); equal to its rows of the "
            f"file: {pr['slice_equal']}; restage: {pr['cache_hit_s'] * 1e3:.2f} ms, plane "
            f"calls {pr['cache_hit_calls']}, same storage {pr['cache_hit_same_storage']}")
        fb = pr["fallback"]
        say(f"  (i) rank {r}, past MAX_RUNS ([{PLACE_FALLBACK_N}, {BATCH}, {SEQ + 1}]): "
            f"{fb['state']} in {fb['seconds']:.2f} s through the whole-read fallback "
            f"(plane calls {fb['plane_calls']}, a Placed {fb['is_placed']}, "
            f"{fb['bytes']} B, equal to its rows of the file: {fb['slice_equal']})")
        checks = {
            "a Placed of this rank's coordinate": pr["is_placed"] and pr["coords"] == [[r]],
            "one plane call": pr["plane_calls"] == 1,
            f"runs read == MAX_RUNS ({PLACE_N})": pr["runs"] == PLACE_N,
            "bytes read == the rank's rows": pr["bytes_read"] == rank_bytes,
            "placement bytes == the rank's rows": pr["placement_bytes"] == rank_bytes,
            "the volume's total == placement bytes": pr["volume_total_bytes"] == rank_bytes,
            "oim_staged_bytes_total rose by the rank's bytes": pr["staged_bytes"] == rank_bytes,
            "growth <= slice + 2 chunks": pr["device_growth_bytes"] <= rank_bytes
            + 2 * FED_CHUNK,
            "equal to the file": pr["slice_equal"],
            "restage a cache hit": pr["cache_hit_calls"] == 0 and pr["cache_hit_staged"] == 0
            and pr["cache_hit_same_storage"],
            "place_batch untouched": len(pr["untouched"]) >= STEPS and all(pr["untouched"]),
            "fallback READY": fb["state"] == "StageState.READY" and fb["plane_calls"] == 1
            and fb["is_placed"] and fb["slice_equal"] and fb["bytes"] == 2 * rank_bytes,
        }
        missed = [k for k, ok in checks.items() if not ok]
        if missed:
            fail(f"(i) rank {r}: {missed}")
    hists = [pr["history"] for pr in per_rank]
    loss_rel, norm_rel = deviation(hists, main["history"])
    losses = [[h["loss"] for h in hist] for hist in hists]
    say(f"  (i) dp over data={PAR_WORLD} on the placed batches: losses {losses[0]}, grad_norms "
        f"{[h['grad_norm'] for h in hists[0]]}; one rank on vol[i] (phase 5): losses "
        f"{main['losses']}; worst step: loss rel {loss_rel:.3e} (tol {PAR_LOSS_REL}), "
        f"grad_norm rel {norm_rel:.3e} (tol {PAR_NORM_REL}); place_batch untouched "
        f"{[pr['untouched'] for pr in per_rank]}; step_s by rank "
        f"{[[round(s, 4) for s in pr['step_s']] for pr in per_rank]}")
    if any(len(ls) != STEPS or not all(math.isfinite(x) for x in ls) for ls in losses) \
            or any(ls != losses[0] for ls in losses):
        fail(f"(i): losses missing, not finite or not equal across ranks: {losses}")
    if loss_rel > PAR_LOSS_REL or norm_rel > PAR_NORM_REL:
        fail(f"(i): differs from one rank: loss rel {loss_rel}, grad_norm rel {norm_rel}")
    want = LAYERS * STEPS
    for r, pr in enumerate(per_rank):
        for n, _ in KERNELS:
            if pr["launches"][n] != want or pr["routes"][n]["wgmma"] != want:
                fail(f"(i) rank {r}: {n} launched {pr['launches'][n]} ({pr['routes'][n]}), "
                     f"want {want} on wgmma")
    train = {"placement_dp": {
        "losses_by_rank": losses, "loss_rel": loss_rel, "grad_norm_rel": norm_rel,
        "launches_by_rank": [{n: pr["launches"][n] for n, _ in KERNELS} for pr in per_rank],
        "stage_s_by_rank": [pr["stage_s"] for pr in per_rank],
        "stage_gbps_by_rank": [pr["stage_gbps"] for pr in per_rank],
        "breakdown_by_rank": [pr["breakdown"] for pr in per_rank],
        "device_growth_by_rank": [pr["device_growth_bytes"] for pr in per_rank],
        "rank_bytes": rank_bytes, "runs_a_rank": per_rank[0]["runs"],
        "fallback_s_by_rank": [pr["fallback"]["seconds"] for pr in per_rank],
        "step_s_by_rank": [pr["step_s"] for pr in per_rank],
        "phase8_stage_gbps": stage8["stage_gbps"]}}

    # (j) head split
    per_rank = [res["slice14"]["headsplit"] for res in ranks]
    hists = [pr["history"] for pr in per_rank]
    ref = refs["headsplit"]
    loss_rel, norm_rel = deviation(hists, ref)
    losses = [[h["loss"] for h in hist] for hist in hists]
    say(f"  (j) llama-tiny's 2 layers at dim 1024, mlp 3584, vocab 32768, 3 heads of 128 / "
        f"1 KV head, bf16, B=1, T={HEADSPLIT_T}, "
        f"model={PAR_WORLD}: losses {losses[0]}, grad_norms "
        f"{[h['grad_norm'] for h in hists[0]]}; one rank: losses {[h['loss'] for h in ref]}, "
        f"grad_norms {[h['grad_norm'] for h in ref]}; worst step: loss rel {loss_rel:.3e}, "
        f"grad_norm rel {norm_rel:.3e}; heads a rank {[pr['heads'] for pr in per_rank]}; "
        f"collectives {per_rank[0]['calls']}")
    if any(len(ls) != STEPS or not all(math.isfinite(x) for x in ls) for ls in losses) \
            or any(ls != losses[0] for ls in losses):
        fail(f"(j): losses missing, not finite or not equal across ranks: {losses}")
    if loss_rel > PAR_LOSS_REL or norm_rel > PAR_NORM_REL:
        fail(f"(j): differs from one rank: loss rel {loss_rel}, grad_norm rel {norm_rel}")
    for r, pr in enumerate(per_rank):
        if pr["heads"] != [(2, 1)]:
            fail(f"(j) rank {r}: attention ran at (q, kv) heads {pr['heads']}, want [(2, 1)]: "
                 "the two whole heads its columns touch, on their one KV head")
        for n, _ in KERNELS:
            if pr["launches"][n] != want or pr["routes"][n]["wgmma"] != want:
                fail(f"(j) rank {r}: {n} launched {pr['launches'][n]} ({pr['routes'][n]}), "
                     f"want {want} on wgmma")
        want_held = (pr["full_bytes"] - pr["whole_bytes"]) // PAR_WORLD + pr["whole_bytes"]
        if pr["held_bytes"] != want_held:
            fail(f"(j) rank {r}: holds {pr['held_bytes']} B of params, want {want_held}")
    pieces: dict = {}
    for pr in per_rank:
        for leaf, piece, s1, s2 in pr["digests"]:
            pieces.setdefault((leaf, tuple(piece)), []).append((s1, s2))
    split = [key for key, seen in pieces.items() if len(set(seen)) > 1]
    replicas = sum(1 for seen in pieces.values() if len(seen) > 1)
    say(f"    replicas: {replicas} leaf pieces held by both ranks, {len(split)} differing")
    if split or not replicas:
        fail(f"(j): replicas differ across ranks after the last step: {split}")
    train["headsplit"] = {
        "losses_by_rank": losses, "loss_rel": loss_rel, "grad_norm_rel": norm_rel,
        "heads_by_rank": [pr["heads"] for pr in per_rank],
        "launches_by_rank": [{n: pr["launches"][n] for n, _ in KERNELS} for pr in per_rank],
        "collective_calls": per_rank[0]["calls"], "replica_pieces_checked": replicas,
        "held_bytes_by_rank": [pr["held_bytes"] for pr in per_rank]}
    fhists = [pr["fault"] for pr in per_rank]
    floss, fnorm = deviation(fhists, ref)
    caught = floss > PAR_LOSS_REL or fnorm > PAR_NORM_REL
    say(f"  planted gather_from in (j): losses {[[h['loss'] for h in hist] for hist in fhists]}, "
        f"grad_norms {[[h['grad_norm'] for h in hist] for hist in fhists]}; worst step: "
        f"loss rel {floss:.3e}, grad_norm rel {fnorm:.3e}: {'caught' if caught else 'NOT caught'}")
    if not caught:
        fail(f"planted gather_from in (j) stays within the limits: loss rel {floss}, "
             f"grad_norm rel {fnorm}")
    return train, {"gather_from": {"run": "headsplit", "loss_rel": floss,
                                   "grad_norm_rel": fnorm}}


def phase_parallel(main: dict, moe_history: list, stage8: dict,
                   device: str = "cuda:0") -> dict:
    """Phase 15: NCCL at world size 1, then PAR_WORLD ranks on ``device``
    over gloo: the collectives, ring/zigzag/Ulysses attention against one
    rank, the trainer under dp, fsdp, zigzag tp_sp and tensor parallelism,
    then MoE and ResNet across ranks, checkpoints under the mesh, the
    pipeline, (i) a volume staged across the mesh and fed in place and (j)
    a model axis that splits a query head, each against one rank
    (``stage8``: phase 8's one-device stage, printed beside (i)'s)."""
    import gc

    import torch

    t_phase = time.monotonic()
    say("  (two ranks sharing one card over gloo: a check of the multi-GPU path, "
        "not a multi-GPU speed)")
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    single = one_rank_references(PAR_WORLD, device, main)
    refs12 = slice12_references(device, moe_history)
    refs_pipe = pipe_references(device, PAR_WORLD)
    refs14 = slice14_references(device)

    say("  NCCL, world size 1")
    (nccl,) = run_ranks(nccl_world1_job, 1, "nccl", PAR_NCCL_TIMEOUT, device)
    _check_collective_result(nccl["collectives"], "NCCL collectives", "nccl")
    n_losses = [r["loss"] for r in nccl["history"]]
    n_norms = [r["grad_norm"] for r in nccl["history"]]
    m_norms = [r["grad_norm"] for r in main["history"][:2]]
    say(f"  --mesh data=1 over NCCL: losses {n_losses}, grad_norms {n_norms} against phase "
        f"5's {main['losses'][:2]}, {m_norms} (equal to the bit wanted); backend "
        f"{nccl['backend']}; collective calls {nccl['calls']}; launches {nccl['launches']}")
    if nccl["backend"] != "nccl" or n_losses != main["losses"][:2] or n_norms != m_norms:
        fail(f"NCCL world 1: losses {n_losses} and grad_norms {n_norms} are not phase 5's "
             f"{main['losses'][:2]} and {m_norms} (backend {nccl['backend']})")
    for name, _ in KERNELS:
        if nccl["routes"][name]["wgmma"] != LAYERS * 2 or nccl["launches"][name] != LAYERS * 2:
            fail(f"NCCL world 1: {name} launched {nccl['launches'][name]} "
                 f"({nccl['routes'][name]}), want {LAYERS * 2} on wgmma")

    say(f"  gloo, {PAR_WORLD} ranks on {device}")
    import functools

    root = tempfile.mkdtemp(prefix="oim-ckpt-")
    vol_root = tempfile.mkdtemp(prefix="oim-placed-")
    try:
        volumes = slice14_volumes(vol_root)
        ranks = run_ranks(functools.partial(ranks_job, root=root, volumes=volumes), PAR_WORLD,
                          "gloo", PAR_RANK_TIMEOUT, device)
        out = check_ranks(ranks, PAR_WORLD, single, "gloo")
        say("  MoE and ResNet across ranks, checkpoints under the mesh")
        resumes = {"moe_fsdp": _resume_one_rank("moe_fsdp", f"{root}/one", device),
                   "ep": _resume_one_rank("ep", f"{root}/ep_one", device)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(vol_root, ignore_errors=True)
    slice12, faults12 = check_slice12(ranks, refs12, resumes)
    out["checkpoint"] = slice12.pop("checkpoint")
    out["train"].update(slice12)
    out["faults"].update(faults12)
    say("  pipeline parallelism (pipe=2): GPipe, 1F1B, interleaved 1F1B, the MoE flagship")
    pipe, faults_pipe, memory = check_pipe(ranks, refs_pipe, PAR_WORLD)
    out["train"].update(pipe)
    out["faults"].update(faults_pipe)
    out["pipe_memory_gb"] = memory
    say("  (i) one volume staged across the mesh, fed in place; (j) a model axis that "
        "splits a query head")
    train14, faults14 = check_slice14(ranks, main, refs14, stage8)
    out["train"].update(train14)
    out["faults"].update(faults14)
    return {"nccl_world1": {"losses": n_losses, "grad_norms": n_norms,
                            "launches": nccl["launches"], "calls": nccl["calls"]},
            **out, "wall_s": time.monotonic() - t_phase,
            "note": "two ranks share one card over gloo: not a multi-GPU speed"}


# Phase 16: the serving daemon's device half. llama3-8b at full width cut to
# DAEMON_LAYERS layers, bf16: 3,846,325,857 bytes of blob (embed and head
# 1.05 GB each, 0.436 GB a layer); full depth would write and stage 16 GB.
DAEMON_LAYERS = 4
DAEMON_SEED = 16
DAEMON_PROMPTS = (17, 48, 100, 200)     # prompt lengths of the 4 greedy requests
DAEMON_NEW = 32                          # tokens each request decodes
DAEMON_ENGINE = dict(max_batch=4, max_seq=256, queue_depth=8, prefix_block=16)


def _bit_equal(a, b) -> bool:
    """Whether two tensors hold the same bytes."""
    import torch

    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                            b.contiguous().reshape(-1).view(torch.uint8)))


def _allocated(device) -> int:
    import torch

    return torch.cuda.memory_allocated(device) if torch.device(device).type == "cuda" else 0


def _daemon_streams(cfg, params, reqs, device) -> list:
    """The greedy streams of ``reqs`` from a ServeEngine on ``params``."""
    from oim_tpu_torch.serve import ServeEngine

    eng = ServeEngine(params, cfg, device=device, **DAEMON_ENGINE)
    try:
        return run_requests(eng, reqs)
    finally:
        eng.stop(drain=False)


def phase_serve_daemon(device="cuda") -> dict:
    """Phase 16: the device half of ``oim_tpu_torch.cli.oim_serve``. The
    CLI module imports without grpc or protobuf; the params of
    ``llama.init`` on the card are packed to a file (``save_packed``, the
    ``--pack-to`` artifact), staged through ``CUDABackend`` as the raw uint8
    file volume ``weights_request`` describes, and restored by the
    grpc-free ``restore_from_array`` whole and as both members of shard 2.
    Every leaf must equal the original to the bit, each member tree
    ``member_params``' piece, ``LAST_RESTORE["bytes_staged"]`` the member
    weight bytes, and an engine on the restored tree must stream the
    original engine's greedy tokens."""
    import dataclasses

    import torch

    import oim_tpu_torch.cli.oim_serve  # noqa: F401 - the daemon's module, for its imports
    from oim_tpu_torch.controller import CUDABackend, StagedVolume
    from oim_tpu_torch.data import plane
    from oim_tpu_torch.models import llama
    from oim_tpu_torch.serve import shard as shardlib
    from oim_tpu_torch.serve import weights as W

    wire = sorted(m for m in sys.modules
                  if m.split(".")[0] == "grpc" or m.startswith("google.protobuf"))
    if wire:
        fail(f"serve daemon: importing oim_tpu_torch.cli.oim_serve loaded {wire[:5]}")
    t_phase = time.monotonic()
    cfg = dataclasses.replace(llama.LLAMA3_8B, n_layers=DAEMON_LAYERS)
    params = llama.init(torch.Generator(device=device).manual_seed(DAEMON_SEED), cfg)
    leaves = dict(_named_leaves(params))
    tmp = tempfile.mkdtemp(prefix="oim-serve-daemon-")
    try:
        path = os.path.join(tmp, "weights.oimw")
        t0 = time.monotonic()
        blob = W.save_packed(params, path)
        pack_s = time.monotonic() - t0
        spec, fparams = W.weights_params(path, blob)
        read_gbps = source_read_gbps(plane.lower_source("file", fparams))
        link_gbps = h2d_gbps()
        bound_s = blob / (min(read_gbps, link_gbps) * 1e9)

        backend = CUDABackend(device=device)
        vol = StagedVolume("weights", b"", spec)
        _sync(device)
        dev0, rss0 = _allocated(device), host_rss()
        t0 = time.monotonic()
        backend.stage(vol, "file", fparams)
        vol.wait()
        stage_s = time.monotonic() - t0
        if vol.error or vol.array is None:
            fail(f"serve daemon: staging the weights blob failed: {vol.error}")
        _sync(device)
        dev1, rss1 = _allocated(device), host_rss()
        if tuple(vol.array.shape) != (blob,) or vol.array.dtype != torch.uint8:
            fail(f"serve daemon: staged {tuple(vol.array.shape)} {vol.array.dtype}, "
                 f"not the raw uint8 volume of {blob} bytes")

        t0 = time.monotonic()
        tree = W.restore_from_array(vol.array)
        _sync(device)
        restore_s = time.monotonic() - t0
        dev2, rss2 = _allocated(device), host_rss()
        last = dict(W.LAST_RESTORE)
        got = dict(_named_leaves(tree))
        if got.keys() != leaves.keys():
            fail(f"serve daemon: restored leaves {sorted(got)} != {sorted(leaves)}")
        base, end = vol.array.data_ptr(), vol.array.data_ptr() + blob
        copied = [n for n, t in got.items() if not base <= t.data_ptr() < end]
        bad = [n for n in leaves if got[n].device != vol.array.device
               or not _bit_equal(got[n], leaves[n])]
        if bad:
            fail(f"serve daemon: restored leaves differ from the originals: {bad}")
        if last != {"shard": 1, "rank": 0, "bytes_staged": blob, "total_bytes": blob}:
            fail(f"serve daemon: LAST_RESTORE {last} after the whole restore of {blob} B")

        members = []
        want_bytes = shardlib.member_weight_bytes(params, 2)
        for rank in (0, 1):
            t0 = time.monotonic()
            member = W.restore_from_array(vol.array, shard=2, rank=rank)
            _sync(device)
            member_s = time.monotonic() - t0
            piece = dict(_named_leaves(shardlib.member_params(params, 2, rank)))
            mine = dict(_named_leaves(member))
            bad = [n for n in piece if not _bit_equal(mine[n], piece[n])]
            if bad or mine.keys() != piece.keys():
                fail(f"serve daemon: member {rank} of shard 2 differs from member_params: "
                     f"{bad or sorted(mine)}")
            if W.LAST_RESTORE["bytes_staged"] != want_bytes:
                fail(f"serve daemon: member {rank} staged {W.LAST_RESTORE['bytes_staged']} B, "
                     f"member_weight_bytes says {want_bytes}")
            members.append({"rank": rank, "restore_s": member_s,
                            "bytes_staged": W.LAST_RESTORE["bytes_staged"]})
            del member, piece, mine

        rs = np.random.RandomState(DAEMON_SEED)
        reqs = [(rs.randint(0, cfg.vocab, n).tolist(), DAEMON_NEW, 0.0, i)
                for i, n in enumerate(DAEMON_PROMPTS)]
        t0 = time.monotonic()
        want = _daemon_streams(cfg, params, reqs, device)
        streams = _daemon_streams(cfg, tree, reqs, device)
        engines_s = time.monotonic() - t0
        if streams != want:
            fail(f"serve daemon: the engine on the restored tree streamed {streams}, "
                 f"the one on the original params {want}")
        del tree, got
        backend.unstage(vol)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {
        "model": f"llama3-8b width, {DAEMON_LAYERS} layers, bf16", "blob_bytes": blob,
        "pack_s": pack_s, "stage_s": stage_s, "stage_gbps": blob / stage_s / 1e9,
        "read_gbps": read_gbps, "h2d_gbps": link_gbps, "bound_s": bound_s,
        "bound_by": "read" if read_gbps < link_gbps else "h2d",
        "restore_s": restore_s, "stage_device_growth_bytes": dev1 - dev0,
        "restore_device_growth_bytes": dev2 - dev1, "stage_host_rss_growth_bytes": rss1 - rss0,
        "restore_host_rss_growth_bytes": rss2 - rss1,
        "leaves": len(leaves), "leaves_copied": len(copied),
        "leaves_viewed": len(leaves) - len(copied), "members": members,
        "member_weight_bytes": want_bytes, "requests": len(reqs), "tokens_each": DAEMON_NEW,
        "streams_equal": True, "engines_s": engines_s, "grpc_loaded": False,
        "phase_s": time.monotonic() - t_phase}
    say(f"  blob {blob} B packed in {pack_s:.2f} s; staged in {stage_s:.3f} s "
        f"({out['stage_gbps']:.2f} GB/s; read {read_gbps:.2f}, pinned H2D {link_gbps:.2f} "
        f"GB/s: bound {bound_s:.3f} s by the {out['bound_by']}); device growth "
        f"{dev1 - dev0} B, host RSS growth {rss1 - rss0} B")
    say(f"  restore {restore_s * 1e3:.2f} ms: {len(copied)} of {len(leaves)} leaves copied "
        f"(offset not a multiple of the element size), device growth {dev2 - dev1} B, host "
        f"RSS growth {rss2 - rss1} B; every leaf equal to the bit")
    member_ms = ", ".join(f"{m['restore_s'] * 1e3:.2f}" for m in members)
    say(f"  shard 2: members 0 and 1 equal to member_params, {want_bytes} B each "
        f"({member_ms} ms)")
    say(f"  {len(reqs)} greedy requests x {DAEMON_NEW} tokens: the restored tree's streams "
        f"equal the original's ({engines_s:.2f} s for both engines); phase {out['phase_s']:.1f} s")
    return out


KV_PROMPT = 1537        # 96 full 16-token blocks and one token to prefill
KV_CHUNK = 512          # the prefill engine's and the reference's prefill_chunk
KV_NEW = 32             # tokens each checked stream decodes
KV_TRIALS = 3           # each reading is the mean of this many
KV_SEED = 17
# Phase 7's geometry without the host tier: evicting the prefix store drops
# a chain, so the next admission adopts it again or recomputes it.
KV_ENGINE = dict(SERVE_ENGINE, kv_host_bytes=0)


def _chain_equal(a: list, b: list) -> bool:
    """Whether two chains of host (k, v) blocks hold the same bytes."""
    return len(a) == len(b) and all(
        x.shape == y.shape and x.tobytes() == y.tobytes()
        for ka, kb in zip(a, b) for x, y in zip(ka, kb))


def reference_logits(cfg, params, prompt: list, stream: list, device):
    """[len(stream), vocab] f32: the logits that predict each token of
    ``stream`` after ``prompt``, from one dense ``cached_forward`` over
    prompt + stream[:-1] (no page pool, page table, chunk or bucket), so
    independent of every engine's pages and of how it prefilled."""
    import torch

    from oim_tpu_torch.models import generate as gen

    toks = list(prompt) + list(stream[:-1])
    cache = gen.init_cache(cfg, 1, len(toks), device=device)
    with torch.inference_mode():
        logits, _ = gen.cached_forward(params, torch.tensor([toks], device=device), cache,
                                       0, cfg)
    out = logits[0, len(prompt) - 1:].float().clone()
    del logits, cache
    return out


@contextlib.contextmanager
def engine_logits(eng, n: int, out: list):
    """Within the block, ``out`` collects the logits ``eng`` computes for
    the tokens it generates after one ``n``-token prompt, alone in the
    engine: its last prefill call's (a chunked prefill's last chunk samples
    the first token), then each decode step's row at the position that
    predicts the next."""
    def prefill(real):
        def fwd(*a):
            last, c = real(*a)
            out[:] = [last.float().clone()]
            return last, c
        return fwd

    def decode(real):
        def fwd(p, t, c, tb, ps):
            logits, c = real(p, t, c, tb, ps)
            rows = (ps == n + len(out) - 1).nonzero()
            if out and len(rows):
                out.append(logits[int(rows[0, 0])].float().clone())
            return logits, c
        return fwd

    with patched(eng, "_prefill_fwd", prefill), patched(eng, "_decode_fwd", decode):
        yield


def hold_tokens(ref, stream: list, what: str) -> dict:
    """Hold an engine's own greedy ``stream`` against ``ref``
    (``reference_logits`` of that stream): at every position the engine's
    token must be the reference's argmax, or short of the reference's top
    logit by at most SERVE_LOGIT_REL x max|logit| (a bf16 near-tie). A
    wrong page, slot or position offset gives a token far down the
    reference's ranking. Reports the argmax agreement, the largest
    shortfall and the positions off the argmax with theirs."""
    import torch

    got = torch.tensor(stream, device=ref.device)
    short = (ref.max(-1).values - ref.gather(1, got[:, None])[:, 0]) / ref.abs().max()
    off = {i: float(short[i]) for i in range(len(stream)) if short[i] > 0}
    worst = float(short.max())
    if not worst <= SERVE_LOGIT_REL:
        i = int(short.argmax())
        fail(f"kv handoff: {what}: token {i} ({stream[i]}) is short of the dense "
             f"reference's argmax ({int(ref[i].argmax())}) by {worst:.4f} x max|logit| "
             f"(limit {SERVE_LOGIT_REL})")
    return {"argmax_agreement": 1 - len(off) / len(stream), "max_shortfall": worst,
            "off_argmax": off}


def parting(ref, stream: list, other: list) -> dict | None:
    """Where ``stream`` first parts from ``other``, read off ``ref``
    (``reference_logits`` of ``stream``, whose context up to there is
    ``other``'s too): the reference's top-2 gap there and each token's
    shortfall from its top logit, all over max|logit|. None when the
    streams do not part."""
    p = first_divergence(stream, other)
    if p >= min(len(stream), len(other)):
        return None
    row, scale = ref[p], ref.abs().max()
    top2 = row.topk(2).values
    return {"position": p, "top2_gap": float((top2[0] - top2[1]) / scale),
            "shortfall": float((top2[0] - row[stream[p]]) / scale),
            "other_shortfall": float((top2[0] - row[other[p]]) / scale)}


def tail_probe(cfg, params, prompt: list, blocks: list, device) -> dict:
    """The prompt's last position (the tail after its full blocks), in two
    fresh pools through ``prefill_into_pages``: as a recompute prefills it
    (the whole prompt in one engine bucket) and as the chunked engine and an
    adoption do (the chain's ``blocks`` staged, then the 1-token tail in
    the smallest bucket). Reports whether the full blocks and the tail
    position's K/V are equal to the bit, the tail's largest K/V
    difference, and the first token's logits' difference over max|logit|."""
    import torch

    from oim_tpu_torch.models import generate as gen
    from oim_tpu_torch.serve import ServeEngine
    from oim_tpu_torch.serve import kvtier

    page, n = KV_ENGINE["prefix_block"], len(prompt)
    start = len(blocks) * page
    n_pages = -(-n // page) + 1
    # An engine slot's table row: max_seq's blocks, the unmapped ones on
    # scratch page 0 (its length sets the attention's shapes).
    table = torch.zeros(KV_ENGINE["max_seq"] // page, dtype=torch.long, device=device)
    table[:n_pages - 1] = torch.arange(1, n_pages, device=device)

    def bucket(k: int) -> int:
        b = ServeEngine.MIN_PREFILL_BUCKET
        while b < k:
            b *= 2
        return min(b, KV_ENGINE["max_seq"])

    def prefill(pool, toks, at):
        padded = torch.zeros(1, bucket(len(toks)), dtype=torch.long)
        padded[0, :len(toks)] = torch.tensor(toks)
        with torch.inference_mode():
            return gen.prefill_into_pages(params, padded.to(device), len(toks), pool, table,
                                          at, cfg, page)[0].float()

    whole = gen.init_page_pool(cfg, n_pages, page, device=device)
    chained = gen.init_page_pool(cfg, n_pages, page, device=device)
    a = prefill(whole, prompt, 0)
    kvtier.stage_pages(chained, list(range(1, len(blocks) + 1)), [k for k, _ in blocks],
                       [v for _, v in blocks])
    b = prefill(chained, prompt[start:], start)
    tail = (slice(None), len(blocks) + 1, slice(0, n - start))
    out = {"blocks_bit_equal": all(bool(torch.equal(whole[s][:, 1:len(blocks) + 1],
                                                    chained[s][:, 1:len(blocks) + 1]))
                                   for s in ("k", "v")),
           "tail_kv_bit_equal": all(bool(torch.equal(whole[s][tail], chained[s][tail]))
                                    for s in ("k", "v")),
           "tail_kv_max_abs_diff": max(float((whole[s][tail].float() - chained[s][tail].float())
                                             .abs().max()) for s in ("k", "v")),
           "first_logits_rel_diff": float((a - b).abs().max() / b.abs().max()),
           "first_token_equal": int(a.argmax()) == int(b.argmax())}
    del whole, chained
    return out


def _mean(xs) -> float:
    return sum(xs) / len(xs)


def phase_kv_handoff(cfg, params, device="cuda") -> dict:
    """Phase 17: the fleet KV tier at phase 7's width and depth. A ``prefill``
    engine (``prefill_chunk`` KV_CHUNK) retires a KV_PROMPT-token prompt and
    its handoff exports the chain through the grpc-free core
    (``export_chain_to``), staged through ``CUDABackend`` as the raw uint8
    file volume ``chain_request`` describes; a ``decode`` engine adopts it
    through ``ChainFetcher`` reading that volume back. Checks: one export
    (counter and event), one adoption (hit, peer tokens, event), the adopted
    pages equal to the exported ones to the bit, every engine's own greedy
    stream held against a dense reference over its own tokens
    (``hold_tokens``), the decode stream equal to the ``mixed`` engine's
    (same chunk) where their pages are, two planted defects (a truncated
    blob, a fingerprint with another page_tokens) falling back to a local
    recompute held the same way, and every pool empty after drain. Where a
    recompute's stream parts from the mixed one, ``parting`` and
    ``tail_probe`` say why. Then readings, each the mean of KV_TRIALS: the
    export's and the adoption's steps (timed by wrapping them), and the
    decode engine's first token with adoption against a local recompute."""
    import gc

    import torch

    from oim_tpu_torch.common import events
    from oim_tpu_torch.common import metrics as M
    from oim_tpu_torch.common import prefixhash
    from oim_tpu_torch.controller import CUDABackend, StagedVolume
    from oim_tpu_torch.serve import ServeEngine
    from oim_tpu_torch.serve import engine as E
    from oim_tpu_torch.serve import kvvolume as KV
    from oim_tpu_torch.serve import weights as W

    t_phase = time.monotonic()
    page = KV_ENGINE["prefix_block"]
    prompt = np.random.RandomState(KV_SEED).randint(0, cfg.vocab, KV_PROMPT).tolist()
    chain = prefixhash.usable_hashes(prompt, page)
    blocks = len(chain)
    fp = KV.config_fingerprint(cfg, page)
    backend = CUDABackend(device=device)
    staged: dict = {}
    stage_growth: list = []

    def publish(volume_id: str, path: str, total_bytes: int) -> int:
        """Stage the packed file as a raw uint8 volume (an earlier volume of
        the same id is unstaged first: a reading re-exports the chain)."""
        if volume_id in staged:
            backend.unstage(staged.pop(volume_id))
        spec, fparams = W.weights_params(path, total_bytes)
        vol = StagedVolume(volume_id, b"", spec)
        _sync(device)
        before = _allocated(device)
        backend.stage(vol, "file", fparams)
        vol.wait()
        if vol.error or vol.array is None:
            raise RuntimeError(f"staging {volume_id} failed: {vol.error}")
        _sync(device)
        stage_growth.append(_allocated(device) - before)
        staged[volume_id] = vol
        return int(vol.array.numel())

    def read(volume_id: str):
        vol = staged.get(volume_id)
        return None if vol is None else KV.volume_bytes(vol.array)

    exports: list = []

    def handoff(eng, hashes):
        exports.append(KV.export_chain_to(eng, hashes, publish))
        return exports[-1]

    def since(seq: int, type_: str) -> list:
        return [e for e in events.recorder().events(type_=type_) if e.seq > seq]

    def last_seq() -> int:
        seen = events.recorder().events()
        return seen[-1].seq if seen else -1

    def run(eng, max_new: int):
        h = eng.submit(prompt, max_new=max_new)
        out = h.result(timeout=RESULT_TIMEOUT)
        if h.finish_reason != "length" or len(out) != max_new:
            fail(f"kv handoff: a {eng.role} request ended {h.finish_reason!r} after "
                 f"{len(out)} tokens; engine error: {eng.error}")
        return out, h.stats

    def run_held(eng):
        """A KV_NEW-token request on ``eng`` and the logits the engine
        computed for each of its tokens (``engine_logits``)."""
        got: list = []
        with engine_logits(eng, KV_PROMPT, got):
            stream, stats = run(eng, KV_NEW)
        if len(got) != KV_NEW:
            fail(f"kv handoff: recorded the {eng.role} engine's logits for {len(got)} of "
                 f"{KV_NEW} tokens")
        return stream, torch.stack(got), stats

    refs: dict = {}

    def held(stream: list, logits, what: str) -> dict:
        """An engine's own stream and logits against the dense reference of
        that stream (one forward for each distinct stream): its logits
        within SERVE_LOGIT_REL x max|logit| at every generated position and
        its tokens by ``hold_tokens``; and where it parts from the mixed
        engine's stream."""
        if tuple(stream) not in refs:
            refs[tuple(stream)] = reference_logits(cfg, params, prompt, stream, device)
        ref = refs[tuple(stream)]
        rel = float((logits - ref).abs().max() / ref.abs().max())
        if not rel <= SERVE_LOGIT_REL:
            fail(f"kv handoff: {what}: the engine's logits differ from the dense reference's "
                 f"by {rel:.4f} x max|logit| (limit {SERVE_LOGIT_REL})")
        return dict(hold_tokens(ref, stream, what), logit_rel_err=rel,
                    stream_equal_prefix=first_divergence(stream, mixed_stream),
                    parting=parting(ref, stream, mixed_stream))

    fetcher = KV.ChainFetcher(read, fp)
    prefill = ServeEngine(params, cfg, device=device, role="prefill", prefill_chunk=KV_CHUNK,
                          **KV_ENGINE)
    decode = ServeEngine(params, cfg, device=device, role="decode", kv_fetch=fetcher,
                         **KV_ENGINE)
    mixed = ServeEngine(params, cfg, device=device, role="mixed", prefill_chunk=KV_CHUNK,
                        **KV_ENGINE)
    prefill.set_handoff_export(handoff)
    engines = (prefill, decode, mixed)
    try:
        # The handoff: one export at the prefill engine's retirement.
        seq = last_seq()
        handoffs = M.SERVE_PREFILL_HANDOFFS.labels(outcome="exported").value
        run(prefill, 1)
        exported = since(seq, events.KV_CHAIN_EXPORTED)
        n_handoffs = M.SERVE_PREFILL_HANDOFFS.labels(outcome="exported").value - handoffs
        if len(exports) != 1 or exports[0] is None or n_handoffs != 1 or len(exported) != 1:
            fail(f"kv handoff: the prefill retirement exported {exports}, "
                 f"{n_handoffs} handoffs counted, {len(exported)} kv_chain_exported events")
        volume = exports[0]
        blob = int(staged[volume].array.numel())
        if volume != KV.chain_volume_id(chain) or exported[0].attrs["blocks"] != blocks:
            fail(f"kv handoff: exported {volume} of {exported[0].attrs['blocks']} blocks, "
                 f"want {KV.chain_volume_id(chain)} of {blocks}")
        mixed_stream, mixed_logits, _ = run_held(mixed)
        # The adoption: the decode engine never held the prefix.
        seq = last_seq()
        hits = M.SERVE_PREFIX_PEER_FETCHES.labels(outcome="hit").value
        peer_tokens = M.SERVE_PREFIX_PEER_TOKENS.value
        decode_stream, decode_logits, stats = run_held(decode)
        n_hits = M.SERVE_PREFIX_PEER_FETCHES.labels(outcome="hit").value - hits
        n_tokens = M.SERVE_PREFIX_PEER_TOKENS.value - peer_tokens
        fetched = since(seq, events.KV_PEER_FETCH)
        if (n_hits, n_tokens, len(fetched), stats["prefix_tokens"]) != (
                1, blocks * page, 1, blocks * page):
            fail(f"kv handoff: the decode engine counted {n_hits} hits, {n_tokens} peer "
                 f"tokens, {len(fetched)} kv_peer_fetch events, prefix tokens "
                 f"{stats['prefix_tokens']}; want 1, {blocks * page}, 1, {blocks * page}")
        sent = KV.unpack_chain(read(volume), fp)[1]
        adopted = decode.snapshot_chain(chain)
        ref_pages = mixed.snapshot_chain(chain)
        if not _chain_equal(adopted, sent):
            fail("kv handoff: the decode engine's adopted pages differ from the exported ones")
        # The prefill and mixed engines ran the same chunked prefill.
        if not _chain_equal(ref_pages, sent):
            fail("kv handoff: the mixed engine's pages differ from the exported ones, which "
                 "the same chunked prefill computed")
        del adopted, ref_pages
        streams = {"mixed": held(mixed_stream, mixed_logits, "the mixed engine's stream"),
                   "adopted": held(decode_stream, decode_logits,
                                   "the decode engine's stream after adoption")}
        # Pages equal to the bit and the same 1-token tail prefill: the
        # decode engine must compute the mixed engine's logits exactly (a
        # wrong page, slot or tail offset would still pass the tolerance).
        if decode_stream != mixed_stream or not torch.equal(decode_logits, mixed_logits):
            fail(f"kv handoff: over pages equal to the bit, the decode engine's logits differ "
                 f"from the mixed engine's by "
                 f"{float((decode_logits - mixed_logits).abs().max()):.3e}; tokens equal for "
                 f"{streams['adopted']['stream_equal_prefix']} of {KV_NEW}")
        del mixed_logits, decode_logits
        say(f"  export: {blob} B blob ({blocks} blocks, volume {volume}); adoption: hit 1, "
            f"{n_tokens:.0f} peer tokens, adopted pages equal to the exported ones to the "
            f"bit, and so are the mixed engine's own")
        say(f"  each engine's own logits and tokens against a dense cached_forward over "
            f"its stream (limit {SERVE_LOGIT_REL:.4f} x max|logit|): " + "; ".join(
                f"{n}: logits {s['logit_rel_err']:.5f}, argmax {s['argmax_agreement']:.4f}, "
                f"largest shortfall {s['max_shortfall']:.5f}" for n, s in streams.items())
            + f"; the decode engine's tokens and logits equal the mixed engine's to the bit")

        # Planted defects: each fetch starts and fails; the engine recomputes.
        defects = {}
        for name, defect in (
                ("truncated blob", KV.ChainFetcher(
                    lambda vid: None if (raw := read(vid)) is None else raw[:len(raw) // 2],
                    fp)),
                ("page_tokens 32", KV.ChainFetcher(read, dict(fp, page_tokens=2 * page)))):
            decode.set_kv_fetch(defect)
            decode.evict_prefix_store()
            seq = last_seq()
            errors = M.SERVE_PREFIX_PEER_FETCHES.labels(outcome="error").value
            stream, logits, stats = run_held(decode)
            fell = since(seq, events.KV_FETCH_FALLBACK)
            n_err = M.SERVE_PREFIX_PEER_FETCHES.labels(outcome="error").value - errors
            if len(fell) != 1 or n_err != 1 or stats["prefix_tokens"] or since(
                    seq, events.KV_PEER_FETCH):
                fail(f"kv handoff: {name}: {len(fell)} kv_fetch_fallback events, {n_err} "
                     f"fetch errors, prefix tokens {stats['prefix_tokens']}; want 1, 1, 0")
            if fell[0].attrs != {"matched_blocks": 0, "chain_blocks": blocks}:
                fail(f"kv handoff: {name}: fallback event {fell[0].attrs}")
            defects[name] = held(stream, logits, f"{name}: the recompute's stream")
            del logits
            recomputed = decode.snapshot_chain(chain)
            defects[name]["pages_bit_equal"] = _chain_equal(recomputed, sent)
            del recomputed
        say("  planted defects fall back to a local recompute: " + "; ".join(
            f"{n}: logits {d['logit_rel_err']:.5f}, argmax {d['argmax_agreement']:.4f}, "
            f"largest shortfall {d['max_shortfall']:.5f}, equal to mixed for {d['stream_equal_prefix']} tokens, "
            f"recomputed pages equal to the exported ones to the bit {d['pages_bit_equal']}"
            for n, d in defects.items()))
        # Why a recompute parts from the mixed stream: the reference's gap
        # where they part, and the tail position computed both ways.
        probe = tail_probe(cfg, params, prompt, sent, device)
        del sent
        for n, d in defects.items():
            if d["parting"]:
                say(f"  {n}: parts from mixed at token {d['parting']['position']}: dense "
                    f"reference top-2 gap {d['parting']['top2_gap']:.5f} x max|logit|, "
                    f"shortfall of the recompute's token {d['parting']['shortfall']:.5f}, "
                    f"of the mixed engine's {d['parting']['other_shortfall']:.5f}")
        say(f"  tail position {KV_PROMPT - 1}, one-shot bucket against the chain + a 1-token "
            f"tail: full blocks equal to the bit {probe['blocks_bit_equal']}, tail K/V equal "
            f"to the bit {probe['tail_kv_bit_equal']} (max|diff| "
            f"{probe['tail_kv_max_abs_diff']:.6f}), first-token logits "
            f"{probe['first_logits_rel_diff']:.6f} x max|logit|, first token equal "
            f"{probe['first_token_equal']}")
        refs.clear()

        # Readings, each step timed by wrapping it (synchronised).
        steps: dict = {k: [] for k in ("snapshot", "pack", "publish", "export", "read",
                                       "unpack", "stage_pages")}

        def timing(name):
            def wrap(real):
                def timed(*a, **k):
                    _sync(device)
                    t0 = time.monotonic()
                    out = real(*a, **k)
                    _sync(device)
                    steps[name].append(time.monotonic() - t0)
                    return out
                return timed
            return wrap

        # The export's steps, through the same core and stage.
        export = timing("export")(KV.export_chain_to)
        with patched(prefill, "snapshot_chain", timing("snapshot")), \
                patched(KV, "pack_chain", timing("pack")):
            for _ in range(KV_TRIALS):
                export(prefill, chain, timing("publish")(publish))
        # The adoption's steps and the decode engine's first token, adopting
        # and recomputing the same prompt (the store evicted between trials).
        decode.set_kv_fetch(KV.ChainFetcher(timing("read")(read), fp))
        growth, peaks, first = [], [], {"adopt": [], "recompute": []}
        with patched(KV, "unpack_chain", timing("unpack")), \
                patched(E, "stage_pages", timing("stage_pages")):
            for _ in range(KV_TRIALS):
                decode.evict_prefix_store()
                _sync(device)
                before = _allocated(device)
                if device != "cpu":
                    torch.cuda.reset_peak_memory_stats(device)
                _, stats = run(decode, 1)
                _sync(device)
                peak = torch.cuda.max_memory_allocated(device) if device != "cpu" else 0
                growth.append(_allocated(device) - before)
                peaks.append(max(peak - before, 0))
                first["adopt"].append(stats["first_token_s"])
        if any(len(steps[k]) != KV_TRIALS for k in ("read", "unpack", "stage_pages")):
            fail(f"kv handoff: {KV_TRIALS} adoptions made "
                 f"{ {k: len(steps[k]) for k in ('read', 'unpack', 'stage_pages')} } reads, "
                 f"unpacks and stage_pages calls")
        decode.set_kv_fetch(None)
        for _ in range(KV_TRIALS):
            decode.evict_prefix_store()
            _, stats = run(decode, 1)
            if stats["prefix_tokens"]:
                fail("kv handoff: the recompute trial found the prefix cached")
            first["recompute"].append(stats["first_token_s"])
        for eng in engines:
            eng.stop(drain=True)
            if eng.error:
                fail(f"kv handoff: the {eng.role} engine died:\n{eng.error}")
            eng.evict_prefix_store()
        used = {eng.role: eng.pool_stats()["used_pages"] for eng in engines}
        if any(used.values()):
            fail(f"kv handoff: pages still used after drain and eviction: {used}")
    finally:
        for eng in engines:
            eng.stop(drain=False)
        for vol in staged.values():
            backend.unstage(vol)
    del engines, prefill, decode, mixed
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    ms = {k: 1e3 * _mean(v) for k, v in steps.items()}
    ms["write"] = ms["export"] - ms["snapshot"] - ms["pack"] - ms["publish"]
    first_ms = {k: 1e3 * _mean(v) for k, v in first.items()}
    link = h2d_gbps() if device != "cpu" else None
    out = {
        "model": f"llama3-8b, {cfg.n_layers} layers, bf16" if cfg.n_layers == 32 else
        f"{cfg.n_layers} layers", "prompt_tokens": KV_PROMPT, "blocks": blocks,
        "prefill_chunk": KV_CHUNK, "engine": KV_ENGINE, "blob_bytes": blob,
        "kv_bytes": blocks * page * 2 * cfg.n_layers * cfg.kv_dim * cfg.dtype.itemsize,
        "volume": volume, "exports": 1, "peer_hits": 1, "peer_tokens": blocks * page,
        "adopted_pages_bit_equal": True, "mixed_pages_bit_equal": True,
        "adopted_logits_bit_equal_to_mixed": True,
        "streams": streams, "defects": defects, "tail_probe": probe, "trials": KV_TRIALS,
        "export_ms": {k: ms[k] for k in ("snapshot", "pack", "write", "publish", "export")},
        "stage_device_growth_bytes": stage_growth,
        "adopt_ms": {k: ms[k] for k in ("read", "unpack", "stage_pages")},
        "adopt_device_growth_bytes": growth, "adopt_peak_growth_bytes": peaks,
        "first_token_ms": first_ms, "first_token_s_trials": first,
        "stage_pages_gbps": 2 * blocks * page * cfg.n_layers * cfg.kv_dim
        * cfg.dtype.itemsize / (ms["stage_pages"] * 1e-3) / 1e9,
        "pinned_h2d_gbps": link, "pools_empty": True, "phase_s": time.monotonic() - t_phase}
    say(f"  export, mean of {KV_TRIALS}: snapshot (D2H, page by page) {ms['snapshot']:.1f} "
        f"ms, pack {ms['pack']:.1f} ms, file write and the rest {ms['write']:.1f} ms, stage "
        f"through CUDABackend {ms['publish']:.1f} ms (all {ms['export']:.1f} ms); each stage "
        f"grew the device by {stage_growth} B")
    say(f"  adoption, mean of {KV_TRIALS}: volume read-back {ms['read']:.1f} ms, unpack "
        f"{ms['unpack']:.2f} ms, stage_pages {ms['stage_pages']:.1f} ms "
        f"({out['stage_pages_gbps']:.1f} GB/s of K/V; a pinned H2D alone "
        f"{link if link is None else round(link, 1)} GB/s); device growth {growth} B, peak "
        f"growth {peaks} B")
    say(f"  decode engine's first token, mean of {KV_TRIALS}: with adoption "
        f"{first_ms['adopt']:.1f} ms, local recompute {first_ms['recompute']:.1f} ms; pools "
        f"empty after drain; phase {out['phase_s']:.1f} s")
    return out


# Phase 18: ranks assembled from the registry, fed by the token stream.
# (b) REG_SHARDS webdataset tars of ~REG_SHARD_BYTES of ``.bin`` members,
# SEQ + 1 seeded int32 tokens each in llama3-8b's vocabulary, the last
# shard one row short (an odd row count: a batch of BATCH straddles the
# epoch's end) and ending in a REG_TAIL-token member (a partial row the
# wrap drops), staged through CUDABackend and streamed a shard at a time
# (``feeds.wds_token_stream`` over ``backend.read_window``) against the
# whole volume's ``_cycle_token_batches``, to the bit, one epoch and
# REG_PAST_WRAP batches more. (a) Two processes share the card, each a
# controller's trainer: they derive their ranks from one registry
# snapshot whose coordinate order is the reverse of its id order
# (REG_ENTRIES; no registry runs on the card, so the rows are a dict as
# GetValues returns them), join over gloo at tcp://127.0.0.1:<free port>
# and take REG_STEPS dp steps at phase 5's width, one row a rank, on the
# stream's first batches.
REG_SHARDS = 4
REG_SHARD_BYTES = 64 << 20
REG_TAIL = 100
REG_PAST_WRAP = 3
REG_STEPS = 2
REG_ENTRIES = {"host-0/address": "127.0.0.1:7000", "host-0/mesh": "1,0,0",
               "host-1/address": "127.0.0.1:7001", "host-1/mesh": "0,0,0",
               "telemetry/host-0.trainer": "127.0.0.1:9000|trainer"}
# Written down from REG_ENTRIES' coordinates, not derived: host-1 sits at
# 0,0,0 and is rank 0.
REG_ORDER = {"host-1": 0, "host-0": 1}


def write_wds_token_shards(tmp: str, vocab: int, seed: int = 18) -> list[str]:
    """REG_SHARDS webdataset tars of SEQ + 1-token ``.bin`` members (the
    last shard one row short and ending in a REG_TAIL-token member),
    synced to the disk."""
    rng = np.random.default_rng(seed)
    member = 512 + -(-(SEQ + 1) * 4 // 512) * 512
    per_shard = REG_SHARD_BYTES // member
    paths = []
    for i in range(REG_SHARDS):
        last = i == REG_SHARDS - 1
        toks = rng.integers(0, vocab, (per_shard - last, SEQ + 1), dtype=np.int32)
        rows = [r.tobytes() for r in toks]
        if last:
            rows.append(rng.integers(0, vocab, REG_TAIL, dtype=np.int32).tobytes())
        path = os.path.join(tmp, f"stream-{i:06d}.tar")
        with tarfile.open(path, "w") as tf:
            for j, payload in enumerate(rows):
                info = tarfile.TarInfo(f"{i:06d}/{j:08d}.bin")
                info.size = len(payload)
                tf.addfile(info, io.BytesIO(payload))
        fsync_file(path)
        paths.append(path)
    return paths


def planted_layout(entries: dict, controller_id: str, port: int) -> tuple[str, int, int]:
    """The planted fault of (a): hosts ranked by id alone, coordinates
    ignored."""
    hosts = sorted(p.split("/")[0] for p in entries if p.endswith("/address"))
    return f"127.0.0.1:{port}", len(hosts), hosts.index(controller_id)


def row_errors(rows_by_id: dict, batches: np.ndarray) -> list[str]:
    """The rows each controller's rank trained, against the rows of each
    global batch its place in REG_ORDER gives it (dp over 2: row r)."""
    errs = []
    for cid, rows in rows_by_id.items():
        want = batches[:, REG_ORDER[cid]]
        if np.asarray(rows).shape != want.shape or not np.array_equal(rows, want):
            errs.append(f"{cid} trained rows other than row {REG_ORDER[cid]} of each batch")
    return errs


def _registry_rank(i: int, controller_id: str, port: int, batches_path: str, device: str,
                   planted: bool, queue) -> None:
    """A spawned process of phase 18 (a): its rank from REG_ENTRIES (from
    ``planted_layout`` when ``planted``), the process group joined
    through ``bootstrap.join_process_group`` (two ranks on one card:
    gloo), a dp step on each saved batch; ("ok", i, result) or ("error",
    i, traceback) on the queue."""
    import traceback

    sys.path.insert(0, str(ROOT))
    try:
        import torch
        import torch.distributed as dist

        from oim_tpu_torch import kernels
        from oim_tpu_torch.cli import oim_trainer
        from oim_tpu_torch.parallel.bootstrap import derive_process_layout, join_process_group
        from oim_tpu_torch.train.trainer import Trainer

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        layout = (planted_layout if planted else derive_process_layout)(
            REG_ENTRIES, controller_id, port)
        coordinator, n, pid = layout
        t0 = time.monotonic()
        join_process_group(coordinator, n, pid, device, local_ranks=2)
        join_s = time.monotonic() - t0
        try:
            batches = np.load(batches_path)
            args = oim_trainer.parse_args(run_argv(["--rules", "dp", "--mesh", f"data={n}"],
                                                   BATCH, SEQ, device, len(batches)))
            trainer = Trainer(oim_trainer.config_from_args(args), device=device,
                              axes=oim_trainer.parse_mesh(args.mesh))
            rows = []
            place = trainer.place_batch

            def seen(batch):
                got = place(batch)
                rows.append(got["tokens"].cpu().numpy())
                return got

            trainer.place_batch = seen
            kernels.reset_launches()
            trainer.run(steps=len(batches), data=iter({"tokens": b} for b in batches))
            _sync(device)
            result = {"layout": list(layout), "join_s": join_s, "history": trainer.history,
                      "rows": np.concatenate(rows), "launches": dict(kernels.LAUNCHES),
                      "routes": {k: dict(r) for k, r in kernels.ROUTES.items()},
                      "backend": trainer.mesh.axis("data").backend,
                      "world": dist.get_world_size(), "rank": dist.get_rank()}
            dist.barrier()
        finally:
            dist.destroy_process_group()
        queue.put(("ok", i, result))
    except BaseException:
        queue.put(("error", i, traceback.format_exc()))


def run_registry_ranks(port: int, batches_path: str, device: str, timeout: float,
                       planted: bool = False) -> dict:
    """(a)'s two processes, host-0 and host-1, spawned in that order;
    their results by controller id."""
    ids = sorted(REG_ORDER)
    got = spawn_collect(_registry_rank, [(i, cid, port, batches_path, device, planted)
                                         for i, cid in enumerate(ids)],
                        timeout, "registry-assembled ranks, processes"
                        + (" (planted id-order layout)" if planted else ""))
    return dict(zip(ids, got))


def phase_registry_stream(device: str = "cuda:0") -> dict:
    """Phase 18: (b) the shard-granular token stream over a staged
    webdataset volume, then (a) two ranks assembled from a registry
    snapshot, trained on the stream's batches."""
    import gc
    import socket

    import torch

    from oim_tpu_torch.cli import oim_trainer
    from oim_tpu_torch.controller import CUDABackend, StagedVolume, StageState
    from oim_tpu_torch.controller.backend import read_window
    from oim_tpu_torch.data import webdataset
    from oim_tpu_torch.data.feeds import _cycle_token_batches, _wds_tokens, wds_token_stream
    from oim_tpu_torch.parallel.bootstrap import derive_process_layout
    from oim_tpu_torch.spec import ArraySpec, WebDatasetParams
    from oim_tpu_torch.train.trainer import Trainer

    t_phase = time.monotonic()
    out: dict = {}
    tmp = tempfile.mkdtemp(prefix="oim-registry-stream-")
    try:
        # (b) the token stream on the card
        cfg = oim_trainer.config_from_args(oim_trainer.parse_args(main_path_argv()))
        t0 = time.monotonic()
        paths = write_wds_token_shards(tmp, cfg.model_config().vocab)
        write_s = time.monotonic() - t0
        sizes = webdataset.shard_sizes(paths)
        backend = CUDABackend(device=device, chunk_bytes=FED_CHUNK)
        vol = StagedVolume("wds-stream", b"", ArraySpec())
        t1 = time.monotonic()
        backend.stage(vol, "webdataset", WebDatasetParams(tuple(paths)))
        vol.wait()
        stage_s = time.monotonic() - t1
        if vol.state != StageState.READY:
            fail(f"registry stream: the webdataset stage ended {vol.state}: {vol.error}")
        arr = vol.array
        total = sum(sizes)
        t1 = time.monotonic()
        whole = _wds_tokens(read_window(arr, 0, 0)[0])
        whole_s = time.monotonic() - t1
        rows = whole.size // (SEQ + 1)
        n_cmp = -(-rows // BATCH) + REG_PAST_WRAP
        if rows % BATCH == 0 or whole.size % (SEQ + 1) != REG_TAIL:
            fail(f"registry stream: {rows} rows and a tail of {whole.size % (SEQ + 1)} tokens: "
                 f"the volume must straddle its wrap and drop a {REG_TAIL}-token tail")
        cycled = _cycle_token_batches(whole, cfg, "wds-stream")
        fetched = {"bytes": 0, "s": 0.0}

        def fetch(offset, length):
            t = time.monotonic()
            got = read_window(arr, offset, length)
            fetched["s"] += time.monotonic() - t
            fetched["bytes"] += got[0].size
            return got

        stream = wds_token_stream(fetch, sizes, SEQ + 1, BATCH, "bin", "wds-stream")
        first, mismatch = [], None
        t1 = time.monotonic()
        for i in range(n_cmp):
            a, b = next(stream), next(cycled)["tokens"]
            if a.dtype != np.int32 or not np.array_equal(a, b):
                mismatch = i
                break
            if i < REG_STEPS:
                first.append(a.copy())
        stream_s = time.monotonic() - t1
        if mismatch is not None:
            fail(f"registry stream: streamed batch {mismatch} differs from the whole volume's")
        # a shard that grew since staging stops the feed
        with open(paths[1], "ab") as f:
            f.write(b"\0" * 512)
        try:
            next(wds_token_stream(lambda o, n: read_window(arr, o, n),
                                  webdataset.shard_sizes(paths), SEQ + 1, BATCH, "bin",
                                  "wds-stream"))
            fail("registry stream: a shard changed since staging did not stop the feed")
        except SystemExit as e:
            changed = str(e)
        if "shards changed since staging?" not in changed:
            fail(f"registry stream: a changed shard gave {changed!r}")
        out["stream"] = {
            "shards": REG_SHARDS, "volume_bytes": total, "rows": rows,
            "write_s": write_s,
            "stage_s": stage_s, "stage_gbps": total / stage_s / 1e9,
            "whole_parse_s": whole_s, "batches_compared": n_cmp,
            "stream_s": stream_s, "stream_gbps": fetched["bytes"] / stream_s / 1e9,
            "fetch_gbps": fetched["bytes"] / fetched["s"] / 1e9,
            "bytes_streamed": fetched["bytes"], "changed_shard_error": changed}
        say(f"  (b) {REG_SHARDS} shards, {total} B, {rows} rows + a {REG_TAIL}-token tail; "
            f"staged in {stage_s:.3f} s ({total / stage_s / 1e9:.2f} GB/s); {n_cmp} streamed "
            f"batches equal to the whole volume's to the bit across the wrap; the stream "
            f"{fetched['bytes'] / stream_s / 1e9:.3f} GB/s with parsing, read_window "
            f"{fetched['bytes'] / fetched['s'] / 1e9:.3f} GB/s; a grown shard stops it")
        backend.unstage(vol)
        del arr, vol, backend
        gc.collect()
        torch.cuda.empty_cache()

        batches = np.stack(first)
        batches_path = os.path.join(tmp, "batches.npy")
        np.save(batches_path, batches)
        # (a) the one-rank reference on the whole batches
        t1 = time.monotonic()
        args = oim_trainer.parse_args(run_argv([], BATCH, SEQ, device, REG_STEPS))
        ref = Trainer(oim_trainer.config_from_args(args), device=device)
        ref.run(steps=REG_STEPS, data=iter({"tokens": b} for b in batches))
        ref_hist = ref.history
        ref_s = time.monotonic() - t1
        del ref
        gc.collect()
        torch.cuda.empty_cache()
        # (a) the two ranks
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        layouts = {cid: derive_process_layout(REG_ENTRIES, cid, port) for cid in REG_ORDER}
        t1 = time.monotonic()
        ranks = run_registry_ranks(port, batches_path, device, timeout=300)
        ranks_s = time.monotonic() - t1
        # the planted fault: the same ranks laid out by id alone, one step
        np.save(batches_path, batches[:1])
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            planted_port = s.getsockname()[1]
        t1 = time.monotonic()
        planted_ranks = run_registry_ranks(planted_port, batches_path, device, timeout=300,
                                     planted=True)
        planted_s = time.monotonic() - t1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    coordinator = f"127.0.0.1:{port}"
    for cid, res in ranks.items():
        want = [coordinator, 2, REG_ORDER[cid]]
        if res["layout"] != want or list(layouts[cid]) != want:
            fail(f"registry ranks: {cid} derived {res['layout']} (here {layouts[cid]}), "
                 f"want {want}")
        if (res["rank"], res["world"]) != (REG_ORDER[cid], 2) or res["backend"] != "gloo":
            fail(f"registry ranks: {cid} joined as rank {res['rank']} of {res['world']} "
                 f"over {res['backend']}")
    errs = row_errors({cid: r["rows"] for cid, r in ranks.items()}, batches)
    if errs:
        fail(f"registry ranks: {errs}")
    for cid, res in planted_ranks.items():
        if (res["rank"], list(res["layout"])) != (
                1 - REG_ORDER[cid], list(planted_layout(REG_ENTRIES, cid, planted_port))):
            fail(f"registry ranks: the planted run's {cid} joined as rank {res['rank']} "
                 f"from {res['layout']}")
    caught = row_errors({cid: r["rows"] for cid, r in planted_ranks.items()},
                        batches[:1])
    if not caught:
        fail("registry ranks: a run laid out by id alone passed the row check")
    hists = [ranks[cid]["history"] for cid in sorted(ranks, key=REG_ORDER.get)]
    losses = [[h["loss"] for h in hist] for hist in hists]
    loss_rel, norm_rel = deviation(hists, ref_hist)
    if any(len(ls) != REG_STEPS or not all(math.isfinite(x) for x in ls) for ls in losses):
        fail(f"registry ranks: losses not finite or missing: {losses}")
    if loss_rel > PAR_LOSS_REL or norm_rel > PAR_NORM_REL:
        fail(f"registry ranks: differ from one rank: loss rel {loss_rel}, "
             f"grad_norm rel {norm_rel}")
    want_launch = LAYERS * REG_STEPS
    for cid, res in ranks.items():
        for n, _ in KERNELS:
            if res["launches"][n] != want_launch or res["routes"][n]["wgmma"] != want_launch:
                fail(f"registry ranks, {cid}: {n} launched {res['launches'][n]} "
                     f"({res['routes'][n]}), want {want_launch} on wgmma")
    step_s = {cid: sum(h["step_s"] for h in r["history"][1:]) / max(1, len(r["history"]) - 1)
              for cid, r in ranks.items()}
    join_s = {cid: r["join_s"] for cid, r in ranks.items()}
    say(f"  (a) ranks from the registry rows: host-1 (0,0,0) rank 0, host-0 (1,0,0) rank 1, "
        f"coordinator {coordinator}, gloo; join {join_s} s; each rank trained its row of "
        f"each batch; a run of the ranks laid out by id alone fails the row check "
        f"({caught[0]})")
    say(f"    losses {losses[0]}; one rank {[h['loss'] for h in ref_hist]}; loss rel "
        f"{loss_rel:.3e} (tol {PAR_LOSS_REL}), grad_norm rel {norm_rel:.3e} (tol "
        f"{PAR_NORM_REL}); step_s (step 2) {step_s}; K1-K3 launches by rank "
        f"{ {cid: r['launches'] for cid, r in ranks.items()} }")
    out["ranks"] = {
        "coordinator_port": port, "layouts": {cid: r["layout"] for cid, r in ranks.items()},
        "join_s": join_s, "step_s": step_s, "losses": losses,
        "reference_losses": [h["loss"] for h in ref_hist], "loss_rel": loss_rel,
        "grad_norm_rel": norm_rel, "planted_caught": caught,
        "launches_by_rank": [ranks[cid]["launches"] for cid in sorted(ranks, key=REG_ORDER.get)],
        "reference_s": ref_s, "ranks_s": ranks_s, "planted_s": planted_s}
    out["phase_s"] = time.monotonic() - t_phase
    say(f"  phase 18: {out['phase_s']:.1f} s (reference {ref_s:.1f} s, ranks {ranks_s:.1f} s, "
        f"planted run {planted_s:.1f} s)")
    return out


# Phase 19: the chaos ladder's engine rungs. The ladder's own model and
# streams (chaos/sim.py: llama.tiny(vocab=64, dim=32, n_layers=2), f32,
# kv_pool_tokens=128) define the rungs, so they are not widened; the fault
# overhead is read at that model (the shortest steps, so an unarmed fire
# costs the largest share) and at phase 5's width and cut.
CHAOS_OVERHEAD_FLOOR = 0.90   # bench.py's gate on fault_overhead_ratio
CHAOS_OVERHEAD_SEED = 19


def phase_chaos(device="cuda") -> dict:
    """Phase 19: ``chaos.ladder.run_engine_rungs`` on the card, each rung in a
    fresh ``EngineSim``: its heal signature read over HTTP from the sim's
    metrics server equals its ``expect``, every stream equals the port's
    ``solo_tokens`` on the card (a stream that differs fails the phase with
    the position where it parts and the reference's top-2 gap there), the
    pool and draft pool are empty and in budget, the valve closed, and the
    census passes. Then ``fault_overhead`` at the ladder's model and at
    llama3-8b width, LAYERS layers, bf16: each ratio must reach
    CHAOS_OVERHEAD_FLOOR."""
    import dataclasses

    import torch

    from oim_tpu_torch.chaos import ladder, sim
    from oim_tpu_torch.models import llama

    t_phase = time.monotonic()
    try:
        report = ladder.run_engine_rungs(device=device)
    except sim.StreamDiverged as err:
        params, cfg = sim.model(device)
        ref = reference_logits(cfg, params, err.prompt, err.expect, device)
        fail(f"chaos: {err}; {parting(ref, err.expect, err.got)}")
    want = [[r.name, *r.expect] for r in ladder.RUNGS if r.name in ladder.ENGINE_RUNGS]
    if report["event_signature"] != want:
        fail(f"chaos: heal signatures {report['event_signature']}, want {want}")
    rungs = {r["name"]: r for r in report["rungs"]}
    for name, rung in rungs.items():
        [row] = rung["census"]["replicas"].values()
        if row["used_pages"] or row["draft_used_pages"] or row["active_slots"] or row["queued"]:
            fail(f"chaos: {name}: the census left work or pages: {row}")
        say(f"  {name}: healed {rung['healed']} in {rung['wall_s']:.3f} s, "
            f"details {json.dumps(rung['details'])}, census {json.dumps(row)}")
    pool = rungs["pool_exhaustion"]["details"]
    if not pool["peak_used_pages"] <= pool["total_pages"]:
        fail(f"chaos: the page pool ran over its budget: {pool}")

    overhead = {"tiny": ladder.fault_overhead(device=device)}
    cfg8 = dataclasses.replace(llama.LLAMA3_8B, n_layers=LAYERS)
    params8 = llama.init(torch.Generator(device=device).manual_seed(CHAOS_OVERHEAD_SEED), cfg8,
                         device=device)
    overhead["llama3_8b_2l_bf16"] = ladder.fault_overhead(device=device, model=(params8, cfg8))
    del params8
    torch.cuda.empty_cache()
    for what, o in overhead.items():
        say(f"  fault_overhead_ratio at {what}: {o['fault_overhead_ratio']} "
            f"(pair spread {o['fault_overhead_pair_spread']}, {o['fault_overhead_rounds']} "
            f"rounds)")
        if o["fault_overhead_ratio"] < CHAOS_OVERHEAD_FLOOR:
            fail(f"chaos: unarmed fault points are not free at {what}: {o}")
    out = {"rungs": report["rungs"], "event_signature": report["event_signature"],
           "seed": report["seed"], "fault_overhead": overhead,
           "phase_s": time.monotonic() - t_phase}
    say(f"  phase 19: {out['phase_s']:.1f} s")
    return out


# Phase 20: the fleet SLO plane's decision on the card. Each replica is a
# max_batch=1 engine at phase 19's second model in a process of its own;
# the SLO engine's clocks are explicit (FLEET_CLOCKS), so its windows and
# holds are read at set points and not waited out.
FLEET_SEED = 20
FLEET_ENGINE = dict(max_batch=1, max_seq=512, queue_depth=16, prefix_cache_bytes=0)
FLEET_PACED, FLEET_BURST, FLEET_NEW = 8, 12, 32
FLEET_PROMPT = (48, 160)                 # prompt lengths drawn from this range
FLEET_WARM = (33, 100, 160)              # one warm request per prefill bucket (64, 128, 256)
FLEET_OBJECTIVE = 0.99
FLEET_WINDOWS = dict(fast_window_s=10.0, slow_window_s=30.0, resolve_hold_s=5.0)
FLEET_CLOCKS = dict(base=0.0, paced=10.0, burst=20.0, two=25.0, quiet=36.0, hold=42.0)
FLEET_THRESHOLD_X = 3.0                  # threshold_s: the first bucket bound above 3x paced p99
FLEET_BOOT_TIMEOUT = 300.0


def fleet_requests(vocab: int, n: int, seed: int) -> list[tuple]:
    """``n`` requests (prompt, max_new, temperature, seed) drawn from
    ``seed``: every other one sampled."""
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, vocab, rs.randint(*FLEET_PROMPT)).tolist(), FLEET_NEW,
             0.0 if i % 2 == 0 else 0.8, 300 + i) for i in range(n)]


def _fleet_replica(name: str, cfg, device: str, inbox, outbox) -> None:
    """A replica process: the phase's weights drawn from FLEET_SEED on
    ``device``, one max_batch=1 engine warmed on each prefill bucket, then
    commands from ``inbox`` until a drain. Each request's stream, finish
    reason and first-token seconds go back on ``outbox`` when it ends."""
    import torch

    from oim_tpu_torch.common.snapshot import metrics_snapshot
    from oim_tpu_torch.models import llama
    from oim_tpu_torch.serve import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device == "cpu":
        torch.set_num_threads(1)
    t0 = time.monotonic()
    params = llama.init(torch.Generator(device=device).manual_seed(FLEET_SEED), cfg,
                        device=device)
    eng = ServeEngine(params, cfg, **FLEET_ENGINE, name=name, device=device)
    for n in FLEET_WARM:
        eng.submit(list(range(1, n + 1)), max_new=2).result(timeout=RESULT_TIMEOUT)
    lock, waiters = threading.Lock(), []

    def send(*msg) -> None:
        with lock:
            outbox.send(msg)

    def finish(i: int, handle) -> None:
        toks = handle.result(timeout=RESULT_TIMEOUT)
        send("done", i, toks, handle.finish_reason, handle.stats["first_token_s"])

    send("ready", time.monotonic() - t0)
    while True:
        msg = inbox.recv()
        if msg[0] == "submit":
            _, i, prompt, n, temp, seed = msg
            w = threading.Thread(target=finish, daemon=True,
                                 args=(i, eng.submit(prompt, max_new=n, temperature=temp,
                                                     seed=seed)))
            waiters.append(w)
            w.start()
        elif msg[0] == "stats":
            send("stats", eng.stats())
        elif msg[0] == "row":
            send("row", {"hist": metrics_snapshot()["hist"]})
        else:  # "drain": residents finish, queued requests close "drained"
            t1 = time.monotonic()
            eng.stop(drain=msg[0] == "drain", timeout=RESULT_TIMEOUT)
            for w in waiters:
                w.join(timeout=RESULT_TIMEOUT)
            send("stopped", time.monotonic() - t1)
            return


class FleetReplica:
    """The phase's handle on one replica process: ``submit`` returns a
    future of (stream, finish reason, first-token s); ``call`` asks the
    process for its stats or its telemetry row."""

    def __init__(self, name: str, cfg, device: str):
        import multiprocessing as mp
        import queue

        self.name, self._futures, self._replies = name, {}, queue.Queue()
        ctx = mp.get_context("spawn")
        inbox, self._to = ctx.Pipe(duplex=False)
        self._from, outbox = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(target=_fleet_replica, args=(name, cfg, device, inbox, outbox),
                                daemon=True, name=f"oim-fleet-{name}")
        self.proc.start()
        inbox.close()
        outbox.close()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        while True:
            try:
                msg = self._from.recv()
            except (EOFError, OSError):
                self._replies.put(("gone",))
                for f in self._futures.values():
                    if not f.done():
                        f.set_exception(RuntimeError(f"replica {self.name} exited"))
                return
            if msg[0] == "done":
                self._futures[msg[1]].set_result(msg[2:])
            else:
                self._replies.put(msg)

    def reply(self, want: str, timeout: float = RESULT_TIMEOUT):
        from queue import Empty

        try:
            msg = self._replies.get(timeout=timeout)
        except Empty:
            fail(f"fleet SLO: replica {self.name} sent no {want!r} within {timeout:.0f} s")
        if msg[0] != want:
            fail(f"fleet SLO: replica {self.name} sent {msg[0]!r}, want {want!r} "
                 f"(exit code {self.proc.exitcode})")
        return msg[1]

    def call(self, what: str):
        self._to.send((what,))
        return self.reply(what)

    def submit(self, i: int, req: tuple):
        import concurrent.futures

        f = self._futures[i] = concurrent.futures.Future()
        self._to.send(("submit", i, *req))
        return f

    def outstanding(self) -> int:
        return sum(not f.done() for f in self._futures.values())

    def stop(self, drain: bool) -> float:
        """Drain (residents finish) or stop; the process's seconds to do it."""
        self._to.send(("drain" if drain else "stop",))
        took = self.reply("stopped")
        self.proc.join(timeout=60)
        if self.proc.exitcode != 0:
            fail(f"fleet SLO: replica {self.name} exited {self.proc.exitcode} after its "
                 f"{'drain' if drain else 'stop'}")
        return took


def hist_delta(after: dict, before: dict) -> dict:
    """The observations between two cumulative snapshots of one grid."""
    if after["le"] != before["le"]:
        fail(f"fleet SLO: the histogram grid changed: {before['le']} -> {after['le']}")
    return {"le": after["le"], "counts": [a - b for a, b in zip(after["counts"], before["counts"])],
            "sum": after["sum"] - before["sum"]}


def finish_all(futures: list, reqs: list, what: str) -> tuple[list, list]:
    """Each request's stream and first-token seconds (the replica's host
    clock); fails on anything but a full-length finish."""
    outs, firsts = [], []
    for (p, n, _, _), f in zip(reqs, futures):
        toks, reason, first_s = f.result(timeout=RESULT_TIMEOUT)
        if reason != "length" or len(toks) != n:
            fail(f"fleet SLO, {what}: a request of {len(p)} tokens ended {reason!r} after "
                 f"{len(toks)} of {n} tokens")
        outs.append(toks)
        firsts.append(first_s)
    return outs, firsts


def phase_fleet_slo(device="cuda") -> dict:
    """Phase 20: the SLO plane's alert-to-spawn decision, fed by the card
    engines' own first-token histograms. Each replica is a max_batch=1
    engine (llama3-8b width, LAYERS layers, bf16, the prefix cache off)
    in a process of its own, as a fleet's replicas are: two engines in one
    process would share one interpreter lock, and at batch 1 the engine is
    bound by its host, so a second one there adds no capacity. Each
    replica publishes its own row, ``{"hist": metrics_snapshot()["hist"]}``
    from its process, and the SLO engine merges the rows.

    (a) FLEET_PACED requests one at a time on r0; their first-token p99
    (``merge.quantile`` of the histogram's delta) sets the latency SLO's
    ``threshold_s``, the first bucket bound above FLEET_THRESHOLD_X times
    it; ``evaluate`` at the paced clock gives no transition. (b) A burst of
    FLEET_BURST requests submitted at once into r0's one slot: its p50 must
    lie above ``threshold_s``, and ``evaluate`` must fire the SLO once
    (``slo_alert_fired`` in the port's ring, ``oim_slo_burn_rate`` at or
    over the threshold). (c) ``reconcile.plan`` on the firing status must
    return one spawn, ``alert:<slo>``; the phase's own ``ReplicaLauncher``
    starts r1 with the same weights and the burst runs again, split over
    r0 and r1 by outstanding requests: every stream equals r0's in (b) to
    the bit, and the p50 falls. (d) Paced traffic, then ``evaluate`` past
    the resolve hold must resolve, and ``plan`` past the scale-down hold
    must drain one replica, r1 with a request resident and one queued: the
    resident finishes its stream, one the drain closed "drained" is served
    by r0 with the same stream, and r1's process exits 0."""
    import dataclasses

    from oim_tpu_torch.autoscale.launcher import ReplicaLauncher
    from oim_tpu_torch.autoscale.reconcile import FleetSpec, ObservedReplica, ReconcileState, plan
    from oim_tpu_torch.common import events
    from oim_tpu_torch.common import metrics as M
    from oim_tpu_torch.models import llama
    from oim_tpu_torch.obs import merge
    from oim_tpu_torch.obs.slo import SLO, SloEngine

    t_phase = time.monotonic()
    clocks = FLEET_CLOCKS
    cfg = dataclasses.replace(llama.LLAMA3_8B, n_layers=LAYERS)
    fleet: dict = {}

    class ProcessLauncher(ReplicaLauncher):
        """Spawn starts a replica process and returns once it is ready
        (weights drawn, engine built, one warm request per prefill
        bucket); drain is the engine's graceful stop in that process."""

        def __init__(self):
            self.spawned, self.drained, self.ready_s, self.drain_s = [], [], {}, {}

        def prestage(self, version: str) -> None:
            pass

        def spawn(self, version: str) -> str:
            rid = f"r{len(self.spawned)}"
            t0 = time.monotonic()
            fleet[rid] = FleetReplica(rid, cfg, device)
            self.spawned.append(rid)
            boot = fleet[rid].reply("ready", FLEET_BOOT_TIMEOUT)
            self.ready_s[rid] = {"spawn_to_ready_s": time.monotonic() - t0, "boot_s": boot}
            return rid

        def drain(self, replica_id: str) -> None:
            self.drain_s[replica_id] = fleet[replica_id].stop(drain=True)
            self.drained.append(replica_id)

    launcher = ProcessLauncher()
    slo_name = "first_token_p99"
    seq0 = max((e.seq for e in events.recorder().events()), default=0)
    seq = itertools.count()

    def new_events(type_: str) -> list:
        return [e for e in events.recorder().events(type_=type_) if e.seq > seq0]

    def ingest(slos) -> None:
        for rid, rep in fleet.items():
            if rid not in launcher.drained:
                slos.ingest(rid, rep.call("row"))

    def run_paced(rep, reqs: list, what: str) -> None:
        for r in reqs:
            finish_all([rep.submit(next(seq), r)], [r], what)

    paced = fleet_requests(cfg.vocab, FLEET_PACED, FLEET_SEED)
    burst = fleet_requests(cfg.vocab, FLEET_BURST, FLEET_SEED + 1)
    out: dict = {"engine": FLEET_ENGINE, "new_tokens": FLEET_NEW, "windows": FLEET_WINDOWS,
                 "clocks": clocks, "objective": FLEET_OBJECTIVE}
    try:
        launcher.spawn("")
        r0 = fleet["r0"]

        # (a) The paced baseline and the threshold it sets.
        before = r0.call("row")
        run_paced(r0, paced, "paced")
        paced_p99 = merge.quantile(hist_delta(r0.call("row")["hist"]["first_token"],
                                              before["hist"]["first_token"]), 0.99)
        bounds = M.SERVE_TOKEN_LATENCY.buckets
        above = [b for b in bounds if b > FLEET_THRESHOLD_X * paced_p99]
        if not math.isfinite(paced_p99) or not above:
            fail(f"fleet SLO: paced first-token p99 {paced_p99} s leaves no bucket bound above "
                 f"{FLEET_THRESHOLD_X}x it in {bounds}")
        threshold_s = above[0]
        slos = SloEngine([SLO(name=slo_name, kind="latency", objective=FLEET_OBJECTIVE,
                              metric="first_token", threshold_s=threshold_s)], **FLEET_WINDOWS)
        # The baseline row predates the paced run: the engine's first
        # sample is r0's cumulative before it.
        slos.ingest("r0", before)
        if slos.evaluate(now=clocks["base"]):
            fail("fleet SLO: a transition at the baseline sample")
        ingest(slos)
        moved = slos.evaluate(now=clocks["paced"])
        if moved:
            fail(f"fleet SLO: the paced run moved the SLO: {moved}")
        out["paced"] = {"p99_s": paced_p99, "threshold_s": threshold_s,
                        "burn": slos.status(slo_name)["burn_fast"]}
        say(f"  r0 ready {launcher.ready_s['r0']['spawn_to_ready_s']:.3f} s after its spawn; "
            f"(a) paced: {FLEET_PACED} requests one at a time on r0, first-token p99 "
            f"{paced_p99:.4f} s; threshold_s {threshold_s} (first bucket bound above "
            f"{FLEET_THRESHOLD_X}x); no transition")

        # (b) The saturating burst on one replica.
        t0 = time.monotonic()
        solo, ft_one = finish_all([r0.submit(next(seq), r) for r in burst], burst, "burst on r0")
        one_s = time.monotonic() - t0
        p50_one, p99_one = pct(ft_one, 0.5), pct(ft_one, 0.99)
        if not p50_one > threshold_s:
            fail(f"fleet SLO: the burst's first-token p50 {p50_one:.4f} s is not above "
                 f"threshold_s {threshold_s}: {FLEET_BURST} requests did not saturate one "
                 f"slot (first tokens {ft_one})")
        ingest(slos)
        fired = slos.evaluate(now=clocks["burst"])
        if [(t["slo"], t["transition"]) for t in fired] != [(slo_name, "fired")]:
            fail(f"fleet SLO: the burst gave transitions {fired}, want one fired")
        burn_gauge = M.SLO_BURN_RATE.labels(slo=slo_name).value
        if len(new_events(events.SLO_ALERT_FIRED)) != 1 or burn_gauge < slos.burn_threshold:
            fail(f"fleet SLO: slo_alert_fired {len(new_events(events.SLO_ALERT_FIRED))} times "
                 f"in the port's ring, oim_slo_burn_rate {burn_gauge} (threshold "
                 f"{slos.burn_threshold})")
        out["burst_one"] = {"p50_s": p50_one, "p99_s": p99_one, "wall_s": one_s,
                            "first_token_s": ft_one}
        out["fired"] = {"burn_fast": fired[0]["burn_fast"], "burn_slow": fired[0]["burn_slow"],
                        "burn_gauge": burn_gauge, "threshold": slos.burn_threshold,
                        "status": slos.status(slo_name)}
        say(f"  (b) burst: {FLEET_BURST} requests at once on r0 in {one_s:.3f} s, first-token "
            f"p50 {p50_one:.4f} s p99 {p99_one:.4f} s; fired at burn fast "
            f"{fired[0]['burn_fast']:.2f} slow {fired[0]['burn_slow']:.2f} (threshold "
            f"{slos.burn_threshold}), oim_slo_burn_rate {burn_gauge:.2f}")

        # (c) The scale-up decision, executed, and the burst on two replicas.
        spec = FleetSpec(min_replicas=1, max_replicas=2, cooldown_s=5.0, scale_down_hold_s=10.0)
        alerts = {n: slos.status(n) for n in slos.firing()}
        actions, state = plan(spec, [ObservedReplica("r0")], alerts, clocks["burst"],
                              ReconcileState())
        if [(a.kind, a.reason) for a in actions] != [("spawn", f"alert:{slo_name}")]:
            fail(f"fleet SLO: plan on the firing alert gave {actions}, want one spawn "
                 f"alert:{slo_name}")
        rid = launcher.spawn(actions[0].version)
        t0 = time.monotonic()
        futures, picks = [], []
        for r in burst:
            picks.append(min(fleet, key=lambda k: (fleet[k].outstanding(), k)))
            futures.append(fleet[picks[-1]].submit(next(seq), r))
        two, ft_two = finish_all(futures, burst, "burst on r0 and r1")
        two_s = time.monotonic() - t0
        diverged = [i for i, (a, b) in enumerate(zip(solo, two)) if a != b]
        if diverged:
            i = diverged[0]
            fail(f"fleet SLO: {len(diverged)} of {FLEET_BURST} streams on two replicas differ "
                 f"from r0's alone, the first (request {i}, on {picks[i]}) at token "
                 f"{first_divergence(solo[i], two[i])}")
        per = {k: picks.count(k) for k in fleet}
        p50_two, p99_two = pct(ft_two, 0.5), pct(ft_two, 0.99)
        if not p50_two < p50_one:
            fail(f"fleet SLO: the burst's first-token p50 on two replicas {p50_two:.4f} s did "
                 f"not fall below one replica's {p50_one:.4f} s")
        ingest(slos)
        moved = slos.evaluate(now=clocks["two"])
        again, state = plan(spec, [ObservedReplica(k) for k in fleet],
                            {n: slos.status(n) for n in slos.firing()}, clocks["two"], state)
        if moved or again:
            fail(f"fleet SLO: the episode moved on two replicas: transitions {moved}, "
                 f"actions {again}")
        out["spawn"] = {"action": dataclasses.asdict(actions[0]), "replica": rid,
                        **launcher.ready_s[rid], "r0": launcher.ready_s["r0"],
                        "target": state.target}
        out["burst_two"] = {"p50_s": p50_two, "p99_s": p99_two, "wall_s": two_s,
                            "first_token_s": ft_two, "requests": per,
                            "streams_equal": FLEET_BURST}
        say(f"  (c) plan: spawn {rid} ({actions[0].reason}), ready "
            f"{launcher.ready_s[rid]['spawn_to_ready_s']:.3f} s after the spawn (boot "
            f"{launcher.ready_s[rid]['boot_s']:.3f} s); the burst on r0+r1 in {two_s:.3f} s, "
            f"first-token p50 {p50_two:.4f} s p99 {p99_two:.4f} s; {FLEET_BURST} streams "
            f"equal r0's alone to the bit; requests by replica {per}")

        # (d) Resolve, then one drain that loses no admitted request.
        run_paced(r0, paced, "paced again")
        ingest(slos)
        quiet = slos.evaluate(now=clocks["quiet"]) + slos.evaluate(now=clocks["hold"])
        if [(t["slo"], t["transition"]) for t in quiet] != [(slo_name, "resolved")] \
                or slos.firing() or len(new_events(events.SLO_ALERT_RESOLVED)) != 1:
            fail(f"fleet SLO: past the resolve hold the transitions were {quiet}, firing "
                 f"{slos.firing()}")
        held, state = plan(spec, [ObservedReplica(k) for k in fleet], {}, clocks["hold"], state)
        if held:
            fail(f"fleet SLO: plan drained before the scale-down hold: {held}")
        # r1 holds a resident request and one queued behind it when the
        # decision lands.
        r1 = fleet[rid]
        inflight = [r1.submit(next(seq), r) for r in burst[:2]]
        deadline = time.monotonic() + RESULT_TIMEOUT
        while True:
            stats = {k: rep.call("stats") for k, rep in fleet.items()}
            if stats[rid]["active_slots"] + stats[rid]["queue_depth"] == 2:
                break
            if time.monotonic() > deadline:
                fail(f"fleet SLO: {rid} never held both requests: {stats[rid]}")
            time.sleep(0.001)
        observed = [ObservedReplica(k, score=st["queue_depth"] - st["free_slots"])
                    for k, st in stats.items()]
        t_down = clocks["hold"] + spec.scale_down_hold_s
        drains, state = plan(spec, observed, {}, t_down, state)
        if [(a.kind, a.replica_id, a.reason) for a in drains] != [("drain", rid, "idle")]:
            fail(f"fleet SLO: plan past the scale-down hold gave {drains}, want one drain "
                 f"of {rid}")
        launcher.drain(drains[0].replica_id)
        # Every admitted request finishes its stream; one the drain closed
        # in the queue (no token emitted) is served again by r0.
        ends = []
        for i, f in enumerate(inflight):
            got, reason, _ = f.result(timeout=RESULT_TIMEOUT)
            ends.append(reason)
            if reason == "drained" and not got:
                [got], _ = finish_all([r0.submit(next(seq), burst[i])], [burst[i]],
                                      "a request drained off r1, on r0")
            elif reason != "length":
                fail(f"fleet SLO: request {i} on the drained replica ended {reason!r} after "
                     f"{len(got)} tokens")
            if got != solo[i]:
                fail(f"fleet SLO: request {i} of the drain ({reason}) gave another stream "
                     f"than r0's alone, from token {first_divergence(solo[i], got)}")
        if ends[0] != "length":
            fail(f"fleet SLO: the drain's outcomes {ends}: the resident did not finish")
        out["resolved"] = {"transitions": quiet, "status": slos.status(slo_name)}
        out["drain"] = {"action": dataclasses.asdict(drains[0]), "drain_s": launcher.drain_s[rid],
                        "outcomes": ends, "exit_code": r1.proc.exitcode, "target": state.target,
                        "spawned": launcher.spawned, "drained": launcher.drained}
        say(f"  (d) resolved by clock {clocks['hold']}; plan at {t_down}: drain {rid} (idle) "
            f"in {launcher.drain_s[rid]:.3f} s, exit code {r1.proc.exitcode}; its requests "
            f"ended {ends}, each stream equal to r0's alone (a 'drained' one served again "
            f"by r0)")
        r0.stop(drain=False)
    finally:
        for rep in fleet.values():
            if rep.proc.is_alive():
                rep.proc.kill()
                rep.proc.join(timeout=30)
    out["phase_s"] = time.monotonic() - t_phase
    say(f"  phase 20: {out['phase_s']:.1f} s")
    return out

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one more llama training step, one decode step "
                         "and one ResNet step (torch.profiler)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check runs on a CUDA card only", 2)
    sys.path.insert(0, str(ROOT))
    try:
        import oim_tpu_torch
    except ImportError as e:
        fail(f"the port is not beside this script ({e}): run it from a checkout", 3)
    if Path(oim_tpu_torch.__file__).resolve().parent.parent != ROOT:
        fail(f"imported oim_tpu_torch from {oim_tpu_torch.__file__}, not from {ROOT}", 3)
    from oim_tpu_torch import kernels
    from oim_tpu_torch.models import llama
    from oim_tpu_torch.train.state import tree_leaves

    t_start = time.monotonic()
    say("== 1. card")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"  {card}")
    say(f"  torch {torch.__version__}  CUDA {torch.version.cuda}  "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}  "
        f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}")

    say("== 2. build (nvcc -Xptxas -v: registers and spills per kernel; g++: the read engine)")
    t0 = time.monotonic()
    built = kernels.build(verbose=True)
    say(f"  built {built} in {time.monotonic() - t0:.1f} s")
    native = build_read_engine()

    say("== 3. kernels against their plain versions")
    cfg, moe_cfg = llama.LLAMA3_8B, moe_flagship()
    bf16 = torch.bfloat16
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    t_rank = PAR_T // PAR_WORLD  # phase 15's positions a rank
    shapes = {  # the attention call of each path phases 5-15 drive:
        # b, tq, tk, h, hkv, d, causal, dtype, seed[, lse cotangent in delta]
        "llama3-8b (phases 5, 8, 9)": (BATCH, SEQ, SEQ, h, hkv, d, True, bf16, 1),
        "MoE flagship (phase 11)": (BATCH, SEQ, SEQ, moe_cfg.n_heads, moe_cfg.n_kv_heads,
                                    moe_cfg.head_dim, True, bf16, 2),
        # Phase 15: a ring's or a zigzag's blocks carry the lse cotangent.
        "phase 15 ring and zigzag diagonal; dp, fsdp a rank; a pipe microbatch; "
        "phase 18's dp row a rank":
            (1, t_rank, t_rank, h, hkv, d, True, bf16, 10, True),
        "phase 15 ring, a full block": (1, t_rank, t_rank, h, hkv, d, False, bf16, 11, True),
        "phase 15 zigzag, q against the held low half":
            (1, t_rank, t_rank // 2, h, hkv, d, False, bf16, 12, True),
        "phase 15 zigzag, q's high half against both held halves":
            (1, t_rank // 2, t_rank, h, hkv, d, False, bf16, 13, True),
        "phase 15 Ulysses, a rank's heads over the whole sequence":
            (1, PAR_T, PAR_T, h // PAR_WORLD, hkv // PAR_WORLD, d, True, bf16, 14),
        "phase 15 one rank: the references, tp_sp's row":
            (1, PAR_T, PAR_T, h, hkv, d, True, bf16, 15),
        # Tensor parallelism: a rank's heads at model=2 (phase 15) and 4.
        "phase 15 tensor parallel, model=2 (16/4 heads a rank)":
            (1, PAR_T, PAR_T, h // 2, hkv // 2, d, True, bf16, 16),
        "tensor parallel, model=4 (8/2 heads a rank)":
            (1, PAR_T, PAR_T, h // 4, hkv // 4, d, True, bf16, 17),
        # MoE across ranks: the flagship's attention at one row a rank
        # (fsdp=2, phase 15 (b)); under expert=2 each rank runs phase 11's.
        "phase 15 MoE flagship under fsdp=2, one row a rank; (h)'s microbatch":
            (1, SEQ, SEQ, moe_cfg.n_heads, moe_cfg.n_kv_heads, moe_cfg.head_dim, True, bf16, 18),
        # (j): a rank attends the 2 whole heads its columns touch (of 3),
        # on their one KV head; the one-rank reference all 3.
        "phase 15 (j) head split at model=2, a rank's 2 whole heads":
            (1, HEADSPLIT_T, HEADSPLIT_T, 2, 1, 128, True, bf16, 20),
        "phase 15 (j) one rank, 3 heads / 1 KV head":
            (1, HEADSPLIT_T, HEADSPLIT_T, 3, 1, 128, True, bf16, 21),
    }
    odd = [
        # b, tq, tk, h, hkv, d, causal, dtype, seed[, lse cotangent in delta]
        (2, 100, 150, 8, 2, 64, False, torch.bfloat16, 2),   # group 4, full, tq < tk
        (1, 77, 130, 4, 4, 128, True, torch.bfloat16, 3),    # group 1, causal, tq < tk
        (1, 130, 70, 4, 1, 40, True, torch.float32, 4),      # tq > tk: fully masked rows
        (1, 200, 120, 4, 4, 128, True, torch.bfloat16, 5),   # the same on the wgmma route, d 128
        (2, 200, 200, 8, 2, 128, True, torch.bfloat16, 6),   # group 4, ragged edges
        (1, 192, 192, 8, 2, 128, True, torch.bfloat16, 7, True),  # delta - g_lse
        (1, 150, 150, 8, 4, 64, True, torch.bfloat16, 9),    # wgmma at d 64, causal, ragged
        (1, 96, 96, 4, 2, 96, True, torch.bfloat16, 8),      # bf16, fma route (d 96)
        # phase 15 (b): the MoE flagship's row a rank in float32, fma route
        (1, SEQ, SEQ, moe_cfg.n_heads, moe_cfg.n_kv_heads, moe_cfg.head_dim, True,
         torch.float32, 19),
    ]
    records = phase_kernels(shapes, odd)

    say("== 4. llama.tiny: card against CPU")
    phase_agreement()

    say("== 5. main path")
    main = phase_main_path(args.profile)
    for rec in records:
        rec["launches"] = main["launches"][rec["name"]]
        rec["routes"] = main["routes"][rec["name"]]

    import gc

    gc.collect()
    torch.cuda.empty_cache()  # the trainer's weights and moments

    say("== 6. serving: llama.tiny on the card against the CPU and against itself")
    phase_serve_agreement()

    say("== 7. serving main path: ServeEngine on llama3-8b, 32 layers, bf16")
    t0 = time.monotonic()
    params = llama.init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    torch.cuda.synchronize()
    say(f"  llama.init on the card: {llama.num_params(cfg) / 1e9:.3f}e9 params, "
        f"{sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9:.2f} GB, "
        f"{time.monotonic() - t0:.1f} s")
    serve = phase_serve_main(cfg, params, "cuda", args.profile)
    say("  tensor-parallel serving: two members sharing the card")
    serve["sharded"] = phase_serve_sharded(cfg, params, serve.pop("_streams"))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    say("== 8. OIM-fed training: a volume staged through CUDABackend feeds the trainer")
    fed = phase_oim_fed(main["step_s"])
    for rec in records:
        rec["oim_fed_launches"] = fed["launches"][rec["name"]]
        rec["oim_fed_windowed_launches"] = fed["windowed_feed"]["launches"][rec["name"]]

    say("== 9. OIM-fed ResNet-50: bench.py's cell through the trainer")
    res = phase_resnet(main, args.profile)
    for rec in records:
        rec["resnet_launches"] = res["launches"][rec["name"]]
        rec["llama_remat_launches"] = res["llama_remat"]["launches"][rec["name"]]

    say("== 10. MoE: llama.tiny with 4 experts on the card against the CPU")
    moe_tiny = phase_moe_agreement()

    say("== 11. MoE main path: the MoE flagship trained through the CLI, 8 layers, bf16")
    moe_main = phase_moe_main(args.profile)
    moe_history = moe_main.pop("history")
    for rec in records:
        rec["moe_launches"] = moe_main["launches"][rec["name"]]
        rec["moe_routes"] = moe_main["routes"][rec["name"]]

    say("== 12. MoE serving: ServeEngine on the MoE flagship, 8 layers, bf16")
    moe_serve = phase_moe_serve(args.profile)

    say("== 13. oim-infer: a llama-tiny-moe checkpoint restored and decoded on the card")
    infer = phase_oim_infer()

    say("== 14. sources: TFRecord, webdataset by URL and ceph staged on the card")
    sources = phase_sources({"synthetic_step_s": main["step_s"], "oim_fed_step_s": fed["step_s"]})
    sources["read_engine"] = native
    for rec in records:
        rec["sources_launches"] = sources["train"]["launches"][rec["name"]]

    say("== 15. multi-rank training on the one card (NCCL at world size 1; two ranks "
        "over gloo)")
    par = phase_parallel(main, moe_history, fed)
    part = {"flash_fwd": ("out",), "flash_bwd_dkv": ("dk", "dv"), "flash_bwd_dq": ("dq",)}
    for rec in records:
        n = rec["name"]
        rec["parallel_launches"] = {
            "nccl_world1": par["nccl_world1"]["launches"][n],
            **{kind: [lr[n] for lr in a["launches_by_rank"]] for kind, a in par["attention"].items()},
            **{run: [lr[n] for lr in t["launches_by_rank"]] for run, t in par["train"].items()}}
        rec["parallel_max_abs_err"] = max(a["max_abs_err"][t] for a in par["attention"].values()
                                          for t in part[n])

    say("== 16. serving daemon: oim_serve's weights staged through CUDABackend and "
        "restored, llama3-8b width, 4 layers")
    daemon = phase_serve_daemon()

    say("== 17. KV handoff: a prefill engine exports a chain, a decode engine adopts it, "
        "llama3-8b, 32 layers, bf16")
    t0 = time.monotonic()
    params = llama.init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    torch.cuda.synchronize()
    say(f"  phase 7's weights drawn again from its seed: {time.monotonic() - t0:.1f} s")
    handoff = phase_kv_handoff(cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    say("== 18. ranks assembled from the registry, fed by the shard-granular token "
        "stream of a staged webdataset volume")
    registry = phase_registry_stream()
    for rec in records:
        rec["registry_launches"] = [lr[rec["name"]]
                                    for lr in registry["ranks"]["launches_by_rank"]]

    say("== 19. the chaos ladder's engine rungs: page-pool exhaustion and the draft "
        "collapse in fresh sims on the card; the unarmed fault points' overhead")
    chaos = phase_chaos()

    say("== 20. the fleet SLO plane on the card: a burst fires the first-token SLO, plan "
        "spawns a second engine, resolve and drain")
    fleet_slo = phase_fleet_slo()

    say("== 21. summary")
    wire = sorted(m for m in sys.modules
                  if m.split(".")[0] == "grpc" or m.startswith("google.protobuf"))
    say(f"  grpc and protobuf modules loaded by the run: {wire or 'none'}")
    if wire:
        fail(f"the card's path loaded the gRPC surface: {wire[:5]}")
    fed["grpc_loaded"] = False
    obs = {"main_path": {"step_s": main["step_s"], **main.pop("obs")},
           "serve": {"decode_step_ms": serve["decode_step_ms"], **serve.pop("obs")},
           "oim_fed": fed.pop("obs"), "moe_train": moe_main.pop("obs"),
           "moe_serve": {"decode_step_ms": moe_serve["decode_step_ms"],
                         **moe_serve.pop("obs")},
           "sources": sources.pop("obs"), "cost_us": obs_costs()}
    say(f"  total {time.monotonic() - t_start:.1f} s")
    say(json.dumps({"main_path": {k: main[k] for k in (
        "step_s", "tokens_per_s", "mfu", "peak_mem_gb", "losses")}, "card": card}))
    say(json.dumps({"serve": {k: v for k, v in serve.items() if k != "profile"},
                    "card": card}))
    say(json.dumps({"oim_fed": fed, "card": card}))
    say(json.dumps({"resnet": {k: v for k, v in res.items() if k != "profile"},
                    "card": card}))
    say(json.dumps({"moe": {"agreement": moe_tiny,
                            "train": {k: v for k, v in moe_main.items() if k != "profile"},
                            "serve": {k: v for k, v in moe_serve.items() if k != "profile"},
                            "oim_infer": infer}, "card": card}))
    say(json.dumps({"sources": sources, "card": card}))
    say(json.dumps({"obs": obs, "card": card}))
    say(json.dumps({"parallel": par, "card": card}))
    say(json.dumps({"serve_daemon": daemon, "card": card}))
    say(json.dumps({"kv_handoff": handoff, "card": card}))
    say(json.dumps({"registry_stream": registry, "card": card}))
    say(json.dumps({"chaos": chaos, "card": card}))
    say(json.dumps({"fleet_slo": fleet_slo, "card": card}))
    say(json.dumps({"kernels": records}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
