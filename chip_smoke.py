"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. build the four CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, started together) and print the build seconds;
2. hold each kernel against its plain PyTorch version on the card:
   ``binned_pull`` for all five ops x visited none / partial / all (lane
   ops at 1, 3, 64 and 130 lanes), on the LDBC proxy's scale-10 pack, a
   star, a hub and a hub whose row spans several hub chunks, and
   ``msbfs_extend`` on the scale-10 ``ShardedBlocks`` and ``KernelBlocks``
   with 64-lane frontiers at several densities, empty stripes included,
   both with ``torch.equal``, and each on operands a graph delta folded on
   the card (``QueryDispatcher.apply_delta``): ``binned_pull``, all five
   ops, on a pack whose rows moved between degree buckets (a rewritten
   ``perm_pad`` and a rebuilt launch record), ``msbfs_extend`` on
   ``ShardedBlocks`` where one tile's slot was freed and claimed by
   another; ``block_spmm`` on ragged columns with empty
   ones, F 64 and 256, float32 and bfloat16, and on a star into one node
   (one destination split into many chunks), and ``flash_attention`` at D
   16, 48, 64, 128 and 256, causal and full, within the tolerances of
   ``tests/test_torch_cuda.py`` (1e-5 for ``spmm``; for attention 2e-5 in
   float32, and rtol 2^-7 / atol 1e-3 of the float32 plain result in
   bfloat16);
3. serve the LDBC proxy at scale 10 through the closed-loop entry point
   (``repro_torch.launch.serve.main``) twice: ``--backend dopt_fused``
   with 8 sources per batch (nTkS, pulls through ``binned_pull``) and the
   default ``recommend`` with 64 sources per batch (nTkMS on
   ``block_mxu``, through ``msbfs_extend``). Every source's levels are
   checked against a BFS written here (sparse products on the card,
   ``BFSOracle``); each kernel's launch
   counter is set to 0 before its run and must be above 0 after it;
3b. serve the same graph through the open-loop entry point (the default
   path of ``serve.main``: a seeded Poisson stream from two tenants
   through ``ServingLoop``) twice, with seeded edge deltas folded into
   the resident operands mid-stream: ``--backend dopt_fused``, 8 sources
   a query, 120 arrivals and 4 deltas (``binned_pull`` on folded packs),
   and the default ``recommend`` with 64 sources a query, 40 arrivals and
   2 deltas (nTkMS on ``block_mxu``, ``msbfs_extend`` on folded tiles),
   both at 20 queries/s with deltas of 64 inserts and 64 deletes. Every
   query's levels are checked against the BFS of the graph version it was
   admitted under (the initial graph plus every earlier delta); launch
   counters as in phase 3; one JSON line per run with the warm and
   all-in p50/p99, cold ms, batches and their mean size in sources,
   overlap occupancy, shed, deadline misses and each delta's report and
   ``apply_delta`` ms; then, on each run's dispatcher and last graph
   version, the run's first 48 queries (40 for x64) as one backlog due at
   time 0, served one query a batch with overlap on, off, off, on
   (``overlap_comparison``): results
   bitwise equal across the four and to the BFS oracle, every finalize but
   the last overlapped, and per run the warm per-batch wall ms p50,
   phase-1 ms (to the join, and to the worker's end of phase 1), finalize
   ms and the finalizes that started before the in-flight batch's phase 1
   ended (``overlap_probe`` wraps the loop for them);
3c. the weighted relax and the non-reach query kinds on the same graph,
   weighted as ``serve`` weights it (``default_rng(7).uniform(0.1, 2.0)``
   float32): ``bellman_ford`` through ``run_recursive_query`` under
   ``ell_push``, ``pull_binned_fused`` and ``dopt_fused`` (the fused
   two must launch ``binned_pull``'s ``min_dist`` op and equal
   ``ell_push`` bitwise; all three equal
   ``scipy.sparse.csgraph.dijkstra`` within rtol 1e-5); then
   ``serve.main --query-kind`` for ``topk_paths``, ``ppr`` and
   ``pattern_counts``, closed loop and open loop (the ``topk_paths``
   stream with one weighted delta), every delivered result against an
   oracle written here: a float32 k-slot Jacobi over the edge list in
   torch on the card (``topk_paths``, bitwise), int64 sparse products wrapped to int32
   (``pattern_counts``, exact), a float32 sparse diffusion (``ppr`` mass
   within rtol 1e-5, atol 1e-7, and equal iteration counts in the closed
   loop); a PPR batch run twice must give the same bits; ``min_dist`` is
   timed at the served shape beside its plain version and its bound;
   each kind needs at least ``MIN_WARM`` warm batches in each loop;
   prints each kind's warm p50 and every warm batch's ms (a p99 only
   where ``P99_MIN`` requests back it), the per-iteration ms of
   ``topk_paths`` and the phase's peak device memory;
4. time ``binned_pull`` and ``msbfs_extend``, their plain versions and a
   one-call PyTorch yardstick (CUDA events) at the shapes the serve runs
   give them, and compute each bound from those inputs; for
   ``binned_pull`` (the level-2 input of the first served batch) also
   the device time per call from a CUDA graph of 20 captured calls and
   the kernel's own duration from ``torch.profiler``, a replayed call
   checked bitwise against an eager one, and the same for a full pass
   (no visited rows) beside its bound and ``torch.sparse.mm`` of the
   reverse CSR with the frontier as a float32 column (the gather without
   the visited skip); ``binned_pull``'s lane ops (``reach_lanes``,
   ``min_parent_lanes``) at nTkMS's pull shape, the 64 lanes of the
   first nTkMS batch at level 2, each beside its byte bound and, for
   ``reach_lanes``, ``torch.sparse.mm`` of the reverse CSR with the 64
   lanes as a float32 ``[n, 64]`` matrix; then release every serve-run
   operand;
5. drive the op entry points of the GNN/LM kernels at full width, each
   kernel's launch counter set to 0 just before and read just after:
   ``spmm_blocks_from_csr(ldbc scale 10, block 128, normalize="mean")``
   (122,958 tiles, 8.06 GB, and their compacted nonzero view, whose
   build is timed apart) and ``spmm`` on seeded float32 features
   ``[44928, 128]``, checked against the plain version (1e-5) and against
   an independent scipy float64 ``A^T X`` (1e-4); ``mha`` at MiniCPM-2B's
   width (B 1, H 36, S 4096, D 64, bfloat16, causal) through the
   tensor-core route, checked against the plain version (rtol 2^-7, atol
   1e-3), and on the same inputs in float32 (2e-5); prints the phase's
   peak device memory;
6. time both at those shapes beside their plain versions, their bounds
   and a library yardstick: ``torch.sparse.mm`` on a CSR ``A^T`` of the
   same nonzeros (float32, TF32 off) and
   ``F.scaled_dot_product_attention(is_causal=True)``; ``spmm``'s bound
   counts the work's bytes (the nonzeros, offsets, X and Y), and its
   L2 gather of source rows is printed beside it; two ``spmm`` launches
   must give the same bits;
6b. the LM serving path at full width: MiniCPM-2B (40 layers, d 2304, 36
   MHA heads of 64, vocab 122,753; 2,725,173,504 parameters) in bfloat16
   with seeded weights (``models.transformer.init`` on the card). (1)
   ``prefill`` of seeded prompts ``[4, 4096]`` (``prefill_32k`` cut from
   32 x 32,768) into a cache of 4,128 slots, then 32 greedy ``decode``
   steps (``decode_32k`` cut to 4 x 4,128); ``mha``'s counter is set to 0
   before the prefill and must read exactly 40 after it, with no
   scan-route call; prefill ms and tokens/s, decode ms a step and tokens/s,
   each beside its bound; (2) the same on the forced scan route, fed the
   kernel route's tokens: every logits row's cosine similarity at least
   0.999; (3) both again in float32 on 2 prompts (``mha``'s ``f32_fma``,
   TF32 off): logits and every cache leaf within 1e-4 of the scan route's,
   relative to their largest magnitude; (4) a kernel-route prefill of 1 x
   32,768 (a 12.1 GB cache): finite logits, 40 launches; (5) ``mha`` at
   the served shape (4, 36, 4096, 64) against its plain version and beside
   SDPA and its bound; ``torch.profiler`` over one prefill and four decode
   steps (``mha``'s share of the prefill, kernels a decode step); (6)
   release everything;
7. ranks: four processes share the card over gloo (every message staged
   through host memory and counted), each building only its own shards
   of the scale-10 operands. On a ``(2, 2)`` mesh each runs
   ``run_recursive_query``'s steps (``prepare_graph`` once a structure
   set, ``pad_sources``, ``build_engine``) for nTkS and nTkMS on
   ``dopt_fused``, ``pull_binned_fused`` and ``block_mxu`` in both state
   layouts, every level held against the BFS oracle and every rank
   holding the same global levels; holds ``binned_pull`` (``reach``,
   ``reach_lanes``, ``min_parent_lanes``) and ``msbfs_extend`` at its
   shard shape against their plain versions; then four graph deltas
   at scale 10, each folded by every rank into its own shards of a
   dispatcher's two nTkS bundles (``QueryDispatcher.apply_delta``): a
   same-shape one of 64 double edge swaps, one that moves two rows
   between degree buckets, one that overflows the forward ELL width
   (edges added to the node of highest out-degree) and one that fills
   shard 0's tile list; after each, every engine case again against
   the BFS of the new graph on every rank, ``binned_pull`` (all five
   ops) on the folded shard pack and ``msbfs_extend`` on the folded
   shard tiles with ``torch.equal`` to their plain versions, and each
   case's launches; then ``serve`` on the
   ``(1, 4)`` mesh, rank 0 driving and the others following: closed
   loop nTkS ``dopt_fused`` x8 (3 batches) and ``recommend`` x64 (2
   batches), and open loops with ``--mutate-stream``: ``dopt_fused``
   x8, 24 arrivals and 2 deltas, ``recommend`` x64, 12 arrivals and 1
   delta, every query against the BFS of the graph it was admitted
   under and every rank's finalized batches equal to rank 0's. Per rank
   it prints the kernels' launches and shard shapes, their times beside
   the plain versions', the collectives' ms per iteration and bytes
   staged, peak device memory, and each delta's ``apply_delta`` ms (and
   the slowest rank's), the bytes its collectives moved, peak device
   memory and the rank's host RSS after the fold. Each engine
   case's own launches are counted apart from the kernel checks': a
   ``pull_binned_fused`` or ``block_mxu`` case must launch its kernel on
   each of its trips, the ``dopt_fused`` cases at least once. A
   world-size-1 NCCL rank then serves ``--closed-loop`` on the card:
   that shows the NCCL group comes up and serves, but on one rank every
   collective is the identity, so no collective runs on NCCL. A rank's
   failure, or a group past ``RANKS_TIMEOUT_S``,
   fails the run;
8. LM training (``launch/train.py``; no kernel: JAX trains through
   ``attention_scan``, the port through its scan route, and ``mha``'s
   counter must stay 0). (8a) two MiniCPM-smoke steps (float32, TF32
   off, batch [2, 64], lr 1e-3) on the card against the same steps on
   the CPU from the same weights: losses and gradient norms within rtol
   1e-5, every parameter within 0.1 lr and all but 0.1% within 1e-6;
   (8b) ``build("minicpm-2b", smoke=False)``: MiniCPM-2B at full width
   cut to ``TRAIN_LAYERS`` (10) of its 40 layers, bf16 parameters,
   float32 AdamW moments, ``train_4k`` cut to [2, 4096], four steps
   (step 0 at lr scale 0 moves no parameter, step 1 moves some; every
   loss and gradient norm finite; a scan-route call a layer a forward
   and one more a layer in the backward's recompute, no kernel-route
   call), then one warm step under ``torch.profiler``; prints the warm
   step's ms, tokens/s, the model-FLOP bound with its formula, the
   optimizer's ms, peak device memory, the device idle share, the five
   largest kernels and the scan attention's share of device time; (8c)
   the full-width config cut to 1 layer, [2, 1024]: an uninterrupted run
   of 4 steps, then ``TrainGuard`` with checkpoints every 2 steps and a
   failure injected at step 3 after the step-2 checkpoint is on disk,
   both under ``torch.use_deterministic_algorithms(True)``: the restored
   state bitwise the saved one, every loss and gradient norm bitwise the
   uninterrupted run's; prints checkpoint bytes and the snapshot, write
   and restore seconds;
9. GNN training (``launch/steps.py``; no kernel: JAX's GNNs aggregate with
   XLA scatters, the port with ``index_add``/``scatter_reduce``, and all
   four kernels' counters must not move). (9c) each arch's smoke config on
   ``molecule`` in float32, card against CPU from the same weights: the
   forward's ``node_out``/``graph_out`` within 1e-5 (relative plus a
   share of the largest magnitude), one train step's loss within 1e-5,
   its gradient norm and each leaf's AdamW moments within 1e-3 (plus
   1e-3 of the leaf's largest), parameters within 1e-6 where the gradient
   clears that bound (else 2 lr: a first AdamW step moves a parameter by
   about lr * sign(g)); (9a) sampled PNA at
   full width (``minibatch_lg``'s cell: 4 layers, d 75, ``d_feat`` 100,
   47 outputs): 1,024 ``GraphSeedStream`` seeds a batch, fanouts (15,
   10), sampled on the card by ``graph.sampler`` from the scale-10 LDBC
   proxy's forward ELL (Reddit's graph cut to the proxy), 169,984 nodes
   and 168,960 edges a batch; the card's sampler against the CPU's on the
   same raw slots, bitwise; under ``torch.use_deterministic_algorithms``
   the first step on the card against a CPU step on the same batch, in
   float64 leaf by leaf within 1e-6 (see ``GNN_F64_TOL``), and in float32
   against that float64 step, each leaf's moments as accurate as the
   CPU's float32 step's (see ``GNN_EXACT_RATIO``); the card's
   deterministic ``index_add`` against the CPU's; then a cold,
   three warm and one profiled step: step ms, sampling ms apart, seeds/s,
   the bound (3 x ``gnn_flops`` at 67 TFLOP/s beside the gathers' and
   scatters' bytes), peak memory, the device idle share; (9b) every arch
   at its full config on ``molecule`` (128 graphs of 30 nodes and 64
   edges) and PNA on ``full_graph_sm``, the same timings, and for SchNet,
   MACE and EquiformerV2 ``graph_out`` under a random rotation within
   2e-3;
10. recsys and the mesh substrate's compression and pipeline
   (``launch/steps.py``'s recsys cells, ``optim/compression.py``,
   ``parallel/pipeline.py``; no kernel: JAX's EmbeddingBag is ``take``
   and ``segment_sum``, its products plain ``@``, and all four kernels'
   counters must not move). (10c) DCN-v2's smoke config in float32, card
   against CPU from the same weights, under
   ``torch.use_deterministic_algorithms``: logits within 1e-5 (relative
   plus a share of the largest), one train step's loss within 1e-5, each
   leaf's AdamW moments within 1e-3 plus 1e-3 of the leaf's largest,
   ``embedding_bag`` sum and mean within 1e-6, retrieval top-k indices
   equal where the scores are distinct; (10a) the full config at Criteo
   width (35,900,000 table rows, 2.30 GB; 576,998,850 parameters, seeded
   on the card): the B 512 forward and one B 2,048 train step against the
   CPU from the same weights (a 2.30 GB copy; the step deterministic),
   then ``train_batch`` (B 65,536 from ``RecsysStream``: a cold, three
   warm and one profiled step; step ms, examples/s, AdamW ms by CUDA
   events, peak memory, device idle share), ``serve_p99`` (B 512, host
   batch to host logits, p50 and p99 over 60 warm calls), ``serve_bulk``
   (B 262,144, ms and rows/s) and ``retrieval_cand`` (1 query against
   1,000,000 seeded candidates of width 64, top 100 against a float64
   sort), each beside its bound (``dcn_flops`` at 67 TFLOP/s float32; the
   candidates' bytes); (10d) four gloo ranks sharing the card (spawned as
   in phase 7): ``pipeline_apply`` over 4 stages of ``tanh(x @ W)``, 8
   microbatches of ``[512, 2304]``, against the serial oracle within
   1e-6, and ``compressed_psum`` of one MiniCPM-2B layer's gradient
   shapes on the card against the same ranks' sum of CPU tensors,
   bitwise, with ms and the wire's and staged bytes;
11. the paper engine's Table 2 cells (``launch/dryrun.py::run_cell`` on
   the card, a ``Mesh`` of one rank; no kernel: the cell's engine extends
   by ``ell_push``, as JAX's ``build_engine`` default does, and all four
   kernels' counters must not move): nTkMS with 64 lanes,
   ``msbfs_lengths`` and the ring OR on a forward ELL cut at 64 slots a
   node, over the seeded generator of each dataset's degree law
   (``steps.PAPER_GRAPHS``). 11a ``ldbc100`` (448,626 nodes) and 11b
   ``livejournal`` (4,847,571 nodes) at their published node counts,
   uncut; 11c ``spotify`` and ``graph500_28`` cut as far as the host's
   generator forces (``PAPER_CUTS``; Graph500-28 does not fit the card
   either), each cut printed in the phase's ``reduced``. For each: every
   lane's levels and every morsel's trip count against ``lane_bfs``, a
   BFS written here in torch on the card over the cut edge set, capped
   at ``max_iters``, and two lanes against
   ``scipy.sparse.csgraph.shortest_path``; prints wall ms (median of 5
   runs after a cold one), trips, GTEPS (edges scanned a second), peak
   device bytes, the roofline terms and the bound at the run's trips,
   and one more run under ``torch.profiler`` (device busy ms, idle share,
   the five largest kernels);
   11d the ``single`` and ``multi`` dry-run records of the four cells
   (analytic: decisions, per-device bytes, roofline);
12. the LM serving cells on a mesh of ranks (``launch/steps.py``'s LM
   cells, ``models/transformer_mesh.py``): MiniCPM-2B at full width cut
   to ``PHASE12_LAYERS`` (2) of its 40 layers, in
   bfloat16 (seed 0) on a ``(2, 2)`` ``("data", "model")`` mesh of four
   gloo ranks sharing the card (``run_ranks``, as phase 7). Each rank
   builds the model and cuts it with ``steps.shard_lm`` (every block
   checked against its spec's slice, cut a second way); a cold and a
   warm ``prefill_32k`` cut to 4 x 4,096 (2 rows a data rank, the
   sequence over ``model``: FSDP gathers on ``data``, the SP gathers and
   reduce-scatters on ``model``, head-parallel attention through
   ``mha``), its caches in the decode cell's layout (4 x 4,128 slots, W
   over ``model``), then 2 decode steps fed a one-rank run's greedy
   tokens. Held against that one-rank run of the same weights on the
   card: each logits row's cosine similarity at least 0.999 (phase 6b's
   bfloat16 tolerance) and the greedy token equal wherever the one-rank
   top-2 margin exceeds twice the row's largest difference; ``mha``
   launches once a layer a prefill on every rank and the other three
   kernels not at all. Prints prefill ms, decode ms a step and tokens/s
   beside the one-rank run's and phase 6b's, and per rank the
   collectives' ms, payload and staged bytes by kind and peak device
   memory;
13. the GNN and recsys cells on a mesh of ranks (``launch/steps.py``'s
   ``_gnn_cell`` and ``_recsys_cell`` on a ``Mesh``, JAX's
   destination-aligned edge slabs): the same ``(2, 2)`` mesh of four
   gloo ranks sharing the card. 13a: two AdamW steps of PNA on
   ``full_graph_sm`` (2,708 nodes, 10,556 edges, ``d_feat`` 1,433) and
   on a ``minibatch_lg`` batch sampled on the card from the scale-10
   proxy's forward ELL (1,024 seeds, fanouts (15, 10)), both in float64,
   and of SchNet, MACE and EquiformerV2 on ``molecule`` in float32, all
   at full width (PNA cut to 1 of its 4 layers and EquiformerV2 to 2 of
   its 12, ``PHASE13_LAYERS``), against the one-rank cell on the card from the same
   seeded weights and batches: the loss and gradient norm of each step,
   every parameter and moment leaf (float64 at 1e-6, parameters within
   1e-6; float32 moments at 1e-3 of a leaf's largest, parameters within
   0.1 lr but for one entry or 1% and all within 2 lr a step). 13b:
   DCN-v2 at full Criteo width (35.9M rows; the table's rows over
   ``model``, FSDP over ``data``): ``serve_p99`` (B 512) and
   ``serve_bulk`` (B 262,144) logits against one rank, ``retrieval_cand``
   (1 x 1,000,000) the merged top 100 against one rank and the one-rank
   top 100 against a float64 sort, two float32 ``train_batch`` steps at
   B 65,536 (loss and norm), then one float64 step at B 2,048 from the
   seed's weights: loss, norm, every leaf, the table by the rows the
   batch touches and every other row's moments 0. 13c, every rank: its
   ``Wire`` records equal the family's ``collective_schedule`` times the
   calls, its parameter blocks their specs' slices, and no kernel counter
   moves. Prints per cell the slowest rank's step or call ms beside the
   one-rank run's, the collectives' ms, payload and staged bytes by kind
   and axis, peak device memory and the real slab layout's edges beside
   ``e_pad``;
14. LM training on a mesh of ranks (``launch/steps.py``'s LM train cell
   on a ``Mesh``, ``models/transformer_mesh.py``'s ``loss_fn``):
   MiniCPM-2B's ``train_4k`` at full width, cut to ``PHASE14_LAYERS`` (1)
   layers and ``TRAIN_BATCH`` (2 x 4,096), on the same ``(2, 2)`` mesh of
   four gloo ranks sharing the card (one row a data rank, the sequence
   over ``model``; the cell's ``minimal`` remat, ``n_micro`` 1). One
   rank's ``launch/train.py::make_train_step`` on the card first: a cold
   and two warm bfloat16 steps from seed 0, then a float32 step from seed
   0 whose parameters and moments are written under ``build/`` as the
   reference. Each rank then cuts the same seeded model with
   ``steps.shard_lm``: a cold and two warm bfloat16 steps, then a float32
   step (TF32 off) held block by block against the reference (the loss
   and the gradient norm at rtol 1e-5, every moment leaf within 1e-4 of
   its largest magnitude, the parameters within 1e-6 for 99.9% and within
   0.1 lr but where the step's gradient is rounding-sized, there 2 lr:
   ``PHASE14_TOL``). Every step's ``Wire`` records equal
   ``collective_schedule(kind="train")``, ``mha`` launches 0 times and no
   kernel counter moves. Then the elastic checkpoint: the float32 state
   saved through ``CheckpointManager.save(shardings=)`` under ``build/``
   (rank 0 writes 4.13 GB), restored onto a ``(1, 4)`` mesh of the same
   ranks and into a one-rank model on the card, every block bitwise
   ``block_of`` the saved arrays (leaf digests against the one-rank
   restore's blocks), and one more float32 step on both meshes held
   against each other at ``PHASE14_TOL``. Prints the slowest rank's
   warm step beside one rank's, per rank the collectives' calls, ms by
   kind, payload and staged bytes by kind and axis, peak device memory
   and the check's spreads, and the checkpoint's bytes, gather, write
   and restore seconds, peak memory and added seconds with the card's
   name and power limit;
15. MoE layers on a mesh of ranks (``models/transformer_mesh.py``'s
   expert-parallel ``_moe``: each ``model`` rank runs its 32 of the 64
   experts over the tokens it holds, with JAX's global capacity, slot
   order and aux loss): olmoe-1b-7b at full width (d 2,048, 16 heads of
   128, 64 experts top-8 of width 1,024, vocab 50,304) in bfloat16 from
   seed 0, on the same ``(2, 2)`` mesh. One rank on the card first:
   ``transformer.prefill``/``decode`` (``nn/moe.py``) at 1 of 16 layers,
   ``prefill_32k`` cut to 4 x 4,096 (T 16,384, capacity 2,560 an expert)
   and 2 greedy decode steps against 4 x 4,098 slots, the one-rank cell
   beside it (its kept slots a layer), the same in float32 (TF32 off:
   the prefill and a decode step; where 1.25 drops nothing, a prefill at
   capacity factor 0.5), then the one-rank train cell at 1
   layer on ``train_4k`` cut to 8 x 1,024 (``n_micro`` 4): two bfloat16
   steps and a float32 step whose state is written under ``build/`` as
   the reference (every leaf, and of each expert tensor the first 4
   experts of each model rank's block). Each rank then cuts the same
   models: a cold and a warm prefill (``mha`` once a layer, at (2, 8,
   4,096, 128); rank 0's first call against the plain version) and the
   decode steps fed the one-rank greedy tokens in bfloat16, the float32
   calls, two bfloat16 train steps and the float32 step checked block by
   block at ``PHASE15_TOL``. The float32 logits must lie within 1e-4 of
   one rank's largest (phase 6b's float32 tolerance); bfloat16 logits are
   compared for the record only (a router's top-8 of 64 flips at near
   ties under rounding in another order); every call's and step's
   ``Wire`` equal to ``collective_schedule``.
   Prints prefill ms, decode ms a step, train step ms and tokens/s beside
   one rank's, the kept slots a layer, per rank the collectives' calls,
   ms, payload and staged bytes by kind and axis and peak memory, and
   ``mha`` at the ranks' shape beside its plain version, SDPA and its
   bound.

Prints the build times, each serve run's warm p50/p99, one ``{"kernels":
[...]}`` JSON line (``route`` is the language, ``cuda``; ``design`` names
the kernel's design: ``row_classes`` for ``binned_pull``, ``csr_chunks``
for ``spmm``, ``wgmma`` for bf16 attention; ``binned_pull`` also carries
``graph_ms``, ``device_us``, a ``full_pass`` object, a ``min_dist``
object with that op's launches and timings and a ``lanes`` object with
the lane ops' timings and their library yardstick; ``flash_attention``
carries a ``served`` object (phase 6b's launches, and ``mha`` at the
served shape beside SDPA and its bound) and a ``mesh`` object (phase
12's launches a prefill on each rank, phase 14's in training: 0, and
phase 15's ``olmoe``: launches a prefill on each rank and ``mha`` at
their shape beside SDPA and its bound);
``binned_pull`` and
``msbfs_extend`` carry a
``shard`` object with each rank's times at its shard shape), phase 8's
``phase 8:``, phase 9's ``phase 9:``, phase 10's ``phase 10:`` and
phase 11's ``phase 11:``, phase 12's ``phase 12:``, phase 13's
``phase 13:``, phase 14's ``phase 14:`` and phase 15's ``phase 15:``
JSON lines, each phase's
seconds (``phase seconds:``), the card's name and power limit, and as
the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import bisect
import contextlib
import copy
import dataclasses
import gc
import inspect
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SCALE = 10.0  # LDBC proxy scale: 44,860 nodes, 1,473,114 edges
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core rate
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SPMM_FEAT = 128  # GNN hidden width of the spmm phase
MIN_WARM = 5  # warm batches each served kind needs in each loop (3c)
ORACLE_THREADS = 8  # 3c's host oracles of one loop's queries, together
P99_MIN = 20  # samples below which phase 3c reports no p99
MHA_SHAPE = (1, 36, 4096, 64)  # MiniCPM-2B: 36 MHA heads, d 64, train_4k
# (rtol, atol) of a kernel against its plain version
SPMM_TOL = (1e-5, 1e-5)  # float32 sums in another order than the plain one
ORACLE_TOL = 1e-4  # float32 kernel against a float64 oracle
# float32: summation order and the online softmax's rescaling; bfloat16: the
# float32 outputs, that close, may round once to neighbouring bfloat16
# values (2^-7 of the value apart at most), plus a floor for tiny outputs
ATTN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2 ** -7, 1e-3)}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over ``rounds`` of CUDA-event time for ``reps`` back-to-back
    calls, per call (a warm-up call first)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return float(np.median(out))


def graph_ms(fn, calls: int = 20, rounds: int = 5):
    """Device time per call with the host out of the way: ``calls`` calls
    captured in one CUDA graph, replayed ``rounds`` times (median, CUDA
    events). Returns (ms per call, the last captured call's output)."""
    fn()  # the launch record and the library, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            out = fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end) / calls)
    return float(np.median(ms)), out


def kernel_us(fn, name: str, calls: int = 20):
    """Mean duration of the device kernels whose name holds ``name`` over
    ``calls`` calls, from ``torch.profiler``; None if it saw none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    durs = [e.time_range.end - e.time_range.start for e in prof.events()
            if name in e.name
            and str(getattr(e, "device_type", "")).endswith("CUDA")]
    return float(np.mean(durs)) if durs else None


def finite(x: float):
    return x if np.isfinite(x) else None


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if torch.equal(a, b):
        return 0.0
    x, y = a.double(), b.double()
    same = (x == y) | (torch.isnan(x) & torch.isnan(y))
    return float(torch.where(same, 0.0, (x - y).abs()).max())


class BFSOracle:
    """Level-synchronous BFS on sparse products on the card (``A^T`` in
    torch's CSR layout times a dense frontier), one column per source:
    levels [k, n] int32, -1 = unreached. Sums of ones are exact in
    float32, so a level is the same on any device."""

    def __init__(self, csr, dev=None):
        at = transpose_csr(csr, np.float32)
        self.n, self.dev = csr.n_nodes, torch.device(dev or DEVICE)
        self.at = torch.sparse_csr_tensor(
            torch.from_numpy(at.indptr.astype(np.int64)),
            torch.from_numpy(at.indices.astype(np.int64)),
            torch.from_numpy(at.data), size=(self.n, self.n)).to(self.dev)

    def levels(self, sources) -> np.ndarray:
        src = torch.as_tensor(np.asarray(sources, np.int64), device=self.dev)
        k = src.numel()
        cols = torch.arange(k, device=self.dev)
        lv = torch.full((self.n, k), -1, dtype=torch.int32, device=self.dev)
        lv[src, cols] = 0
        f = torch.zeros((self.n, k), dtype=torch.float32, device=self.dev)
        f[src, cols] = 1.0
        visited = f > 0
        d = 0
        while bool(f.any()):
            d += 1
            new = ((self.at @ f) > 0) & ~visited
            visited |= new
            lv[new] = d
            f = new.to(torch.float32)
        return lv.T.contiguous().cpu().numpy()

    def levels_of(self, queries) -> list:
        """Levels of many source arrays, the sources batched into columns
        of 1,024."""
        flat = np.concatenate([np.asarray(q, np.int64) for q in queries])
        lv = np.concatenate([self.levels(flat[i : i + 1024])
                             for i in range(0, len(flat), 1024)])
        bounds = np.cumsum([0] + [len(q) for q in queries])
        return [lv[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


class TopkOracle:
    """k-best walk lengths as a float32 Jacobi over the edge list, in torch
    on the card: each round every node's k smallest of its seed value and
    ``d[u, j] + w`` over its in-edges (one sort of (node, value) keys a
    round; values are non-negative, so their float32 bit patterns sort as
    the values do). Float32 adds round alike on any device."""

    def __init__(self, csr, cap: int, k: int = 4, dev=None):
        src, dst = csr.edge_list()
        self.dev = torch.device(dev or DEVICE)
        self.src = torch.from_numpy(src.astype(np.int64)).to(self.dev)
        self.dst = torch.from_numpy(dst.astype(np.int64)).to(self.dev)
        self.w = torch.from_numpy(csr.weights.astype(np.float32)).to(
            self.dev)
        self.n, self.k, self.cap = csr.n_nodes, k, cap

    def dists(self, source: int) -> np.ndarray:
        """At the fixpoint, or after ``cap`` rounds as the engine stops."""
        n, k, dev = self.n, self.k, self.dev
        d = torch.full((n, k), float("inf"), device=dev)
        d[source, 0] = 0.0
        seed_t = torch.tensor([source], dtype=torch.int64, device=dev)
        seed_v = torch.zeros(1, dtype=torch.float32, device=dev)
        for _ in range(self.cap):
            e, j = torch.nonzero(torch.isfinite(d[self.src]), as_tuple=True)
            vals = torch.cat([d[self.src[e], j] + self.w[e], seed_v])
            tgt = torch.cat([self.dst[e], seed_t])
            key = (tgt << 32) | vals.view(torch.int32).to(torch.int64)
            key = torch.sort(key).values
            t = key >> 32
            v = (key & 0xFFFFFFFF).to(torch.int32).view(torch.float32)
            head = torch.ones_like(t, dtype=torch.bool)
            head[1:] = t[1:] != t[:-1]
            pos = torch.arange(key.numel(), device=dev)
            first = torch.cummax(torch.where(head, pos, 0), 0).values
            rank = pos - first
            keep = rank < k
            new = torch.full((n, k), float("inf"), device=dev)
            new[t[keep], rank[keep]] = v[keep]
            if torch.equal(new, d):
                break
            d = new
        return d.cpu().numpy()

    def dists_of(self, sources) -> list:
        return [self.dists(int(s)) for s in sources]


def transpose_csr(csr, dtype):
    """``A^T`` as a scipy CSR (rows = destinations, columns ascending)."""
    from scipy.sparse import csr_matrix

    n = csr.n_nodes
    a = csr_matrix((np.ones(csr.n_edges, dtype), csr.indices, csr.indptr),
                   shape=(n, n))
    at = a.T.tocsr()
    at.sort_indices()
    return at


def ppr_oracle(at32, deg, sources, cap, alpha=0.15, eps=1e-4):
    """Residual diffusion in float32, one column per source, for at most
    ``cap`` rounds: each row's pushed sum adds its in-edges in ascending
    source order (scipy's CSR product), ``mass`` is updated in float64
    and rounded to float32 (the port rounds once, so the two may differ
    by an ulp at a halfway point). Returns (mass [n, s], iterations [s])."""
    n, s = at32.shape[0], len(sources)
    r = np.zeros((n, s), np.float32)
    r[np.asarray(sources), np.arange(s)] = 1.0
    mass = np.zeros((n, s), np.float32)
    f = np.where(r > np.float32(eps), r, np.float32(0.0))
    iters = np.zeros(s, np.int64)
    a32 = np.float32(alpha)
    for _ in range(cap):
        if not f.any():
            break
        iters += f.any(axis=0)
        share = (np.float32(1.0 - alpha) * f) / deg[:, None]
        pushed = (at32 @ share).astype(np.float32)
        mass = (mass.astype(np.float64)
                + np.float64(a32) * f.astype(np.float64)).astype(np.float32)
        r = r - f + pushed
        f = np.where(r > np.float32(eps), r, np.float32(0.0))
    return mass, iters


def pattern_oracle(at64, sources):
    """(wedges, closed) int32 per source: int64 products wrapped to int32
    (the port's int32 sums wrap the same way)."""
    x = np.zeros((at64.shape[0], len(sources)), np.int64)
    x[np.asarray(sources), np.arange(len(sources))] = 1
    x1 = at64 @ x
    x2 = at64 @ x1
    x3 = at64 @ x2
    return x2.T.astype(np.int32), x3.T.astype(np.int32)


def phase_3c(dev, csr, check, launches) -> dict:
    """The weighted relax and the non-reach query kinds (module doc, 3c).
    Adds the main-path ``binned_pull`` launches to ``launches`` and
    returns the phase's figures."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    from repro_torch.core import policy_ntks, run_recursive_query
    from repro_torch.core.edge_compute import QUERY_KINDS
    from repro_torch.graph import csr as gcsr
    from repro_torch.graph.delta import apply_delta_csr
    from repro_torch.graph.partition import padded_n
    from repro_torch.kernels.binned_pull import binned_pull as bp_mod
    from repro_torch.kernels.binned_pull.ops import (
        binned_pull,
        build_pack,
        launch_record,
    )
    from repro_torch.kernels.common import to_device
    from repro_torch.launch import serve
    from repro_torch.runtime.dispatch import QueryDispatcher

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    n = csr.n_nodes
    # the served engines' iteration cap (the dispatcher's default)
    cap = inspect.signature(QueryDispatcher).parameters["max_iters"].default
    rng = np.random.default_rng(7)  # serve's weighting of topk_paths
    csr_w = gcsr.CSRGraph(csr.indptr, csr.indices, rng.uniform(
        0.1, 2.0, csr.n_edges).astype(np.float32))
    out = {}

    # bellman_ford through run_recursive_query, three backends
    bf_src = np.random.default_rng(3).integers(0, n, 4).astype(np.int32)
    a_w = csr_matrix((csr_w.weights.astype(np.float64), csr_w.indices,
                      csr_w.indptr), shape=(n, n))
    ref = dijkstra(a_w, indices=bf_src)
    runs, md_launches = {}, 0
    for ext in ("ell_push", "pull_binned_fused", "dopt_fused"):
        t0 = time.perf_counter()
        bp_mod.fused_binned_pull.launches = 0
        res = run_recursive_query(dev, csr_w, bf_src, policy_ntks(),
                                  edge_compute="bellman_ford", extend=ext)
        torch.cuda.synchronize()
        count = bp_mod.fused_binned_pull.launches
        dist = res.state.dist[:, :n].cpu().numpy()
        if not np.allclose(dist, ref, rtol=1e-5, atol=0.0):
            fail(f"bellman_ford on {ext} differs from dijkstra (max rel "
                 f"err {np.nanmax(np.abs(dist - ref) / ref)})")
        if ext != "ell_push":
            if count <= 0:
                fail(f"bellman_ford on {ext} never launched binned_pull's "
                     "min_dist op")
            launches["binned_pull"] += count
            md_launches += count
            for a, b in zip(runs["ell_push"]["state"], res.state):
                if not torch.equal(a, b):
                    fail(f"bellman_ford on {ext} differs from ell_push")
        runs[ext] = {"state": res.state,
                     "iterations": res.iterations.tolist(),
                     "min_dist_launches": count,
                     "seconds": time.perf_counter() - t0}
        del res
    out["bellman_ford"] = {k: {f: v for f, v in r.items() if f != "state"}
                           for k, r in runs.items()}
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    print("phase 3c: bellman_ford " + json.dumps(out["bellman_ford"]),
          flush=True)

    # min_dist at the served shape: the relax's input after two rounds
    n_pad = padded_n(n, 1, 32)
    pack = to_device(build_pack(gcsr.binned_rev_csr(csr_w, n_pad), n_pad),
                     dev)
    rec = launch_record(pack)
    dist = torch.full((n_pad,), float("inf"), device=dev)
    dist[torch.as_tensor(bf_src, device=dev).long()] = 0.0
    gdu = dist.clone()
    for _ in range(2):
        cand = binned_pull(pack, gdu, op="min_dist")
        better = cand < dist
        dist = torch.minimum(dist, cand)
        gdu = torch.where(better, dist, float("inf"))
    check("binned_pull", binned_pull(pack, gdu, op="min_dist"),
          binned_pull(pack, gdu, op="min_dist", use_ref=True),
          "ldbc-10 weighted/min_dist at the served shape")
    plan = rec.plan
    # live slots only: a row's slab width past its in-degree is padding
    slots = int(sum(int((sl[0] != n_pad).sum()) for sl in pack.slabs))
    rows = pack.rows_local
    # an id and a weight a live slot, gsrc and perm_pad in, a float32 a
    # row out
    md_bytes = 8 * slots + 4 * gdu.numel() + 4 * plan.rbp + 4 * rows
    md_ops = 2 * slots  # an add and a min a slot
    md_call = lambda: binned_pull(pack, gdu, op="min_dist")
    md_graph_ms, md_out = graph_ms(md_call)
    check("binned_pull", md_out, md_call(),
          "ldbc-10 weighted/min_dist, CUDA graph replay")
    out["min_dist"] = {
        "launches": md_launches,
        "ms": time_ms(md_call),
        "graph_ms": md_graph_ms,
        "device_us": kernel_us(md_call, "binned_pull_kernel"),
        "plain_ms": time_ms(lambda: binned_pull(
            pack, gdu, op="min_dist", use_ref=True), reps=5),
        "bound_ms": max(md_bytes / HBM_BYTES_PER_S,
                        md_ops / F32_OPS_PER_S) * 1e3,
        "bound_by": ("bytes" if md_bytes / HBM_BYTES_PER_S
                     >= md_ops / F32_OPS_PER_S else "operations"),
        "library_ms": None,
        "shape": f"op min_dist, gsrc [{gdu.numel()}] f32 "
                 f"({int(torch.isfinite(gdu).sum())} finite), "
                 f"{len(plan.widths)} weighted slabs, {slots} live slots "
                 f"of {pack.capacity_slots}",
    }
    del pack, rec, dist, gdu, cand, md_call, md_out
    torch.cuda.empty_cache()

    # serve.main --query-kind, closed and open loop
    at32 = transpose_csr(csr, np.float32)
    at64 = transpose_csr(csr, np.int64)
    deg = np.maximum(csr.degrees, 1).astype(np.float32)
    topk_orc = TopkOracle(csr_w, cap)
    # enough batches that each kind has at least MIN_WARM warm ones in
    # each loop (the first batches of a kind build its engines)
    kind_runs = {
        "topk_paths": (["--sources-per-batch", "2", "--batches", "8"],
                       ["--sources-per-batch", "1", "--arrivals", "10",
                        "--mutate-stream", "1"]),
        "ppr": (["--sources-per-batch", "4", "--batches", "8"],
                ["--sources-per-batch", "2", "--arrivals", "10"]),
        "pattern_counts": (["--sources-per-batch", "4", "--batches", "8"],
                           ["--sources-per-batch", "2", "--arrivals", "10"]),
    }

    def expect(kind, sources, graph_w=None):
        """The oracle's per-source result rows of one query."""
        if kind == "topk_paths":
            orc = topk_orc if graph_w is None else TopkOracle(graph_w, cap)
            return {"dists": np.stack(orc.dists_of(sources))}, None
        if kind == "ppr":
            mass, iters = ppr_oracle(at32, deg, sources, cap)
            return {"mass": mass.T}, iters
        wedges, closed = pattern_oracle(at64, sources)
        return {"wedges": wedges, "closed": closed}, None

    def compare(kind, got, exp, what):
        for leaf, e in exp.items():
            g = got[leaf]
            ok = (np.allclose(g, e, rtol=1e-5, atol=1e-7) if kind == "ppr"
                  else np.array_equal(g, e))
            if not ok:
                fail(f"{kind} {what}: {leaf} differs from the oracle")

    peak_all = torch.cuda.max_memory_allocated()
    for kind, (closed_args, open_args) in kind_runs.items():
        leaves = QUERY_KINDS[kind].result_leaves
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        records = []
        bp_mod.fused_binned_pull.launches = 0
        rc = serve.main(["--closed-loop", "--device", str(dev), "--dataset",
                         "ldbc", "--scale", str(SCALE), "--query-kind", kind,
                         *closed_args], on_batch=records.append)
        torch.cuda.synchronize()
        if rc != 0:
            fail(f"serve --query-kind {kind} --closed-loop exited {rc}")
        launches["binned_pull"] += bp_mod.fused_binned_pull.launches
        warm, per_iter = [], []
        # the host oracles of all batches at once, on threads (numpy
        # releases the GIL in its sorts and gathers)
        with ThreadPoolExecutor(ORACLE_THREADS) as pool:
            exps = list(pool.map(lambda r: expect(kind, r.sources),
                                 records))
        for r, (exp, exp_iters) in zip(records, exps):
            k = len(r.sources)
            got = {leaf: getattr(r.result.state, leaf)[:k, :n].cpu().numpy()
                   for leaf in leaves}
            iters = r.result.iterations[:k].numpy()
            compare(kind, got, exp, f"closed-loop batch {r.index}")
            if exp_iters is not None and not np.array_equal(iters,
                                                            exp_iters):
                fail(f"{kind} batch {r.index}: iterations {iters.tolist()} "
                     f"against the oracle's {exp_iters.tolist()}")
            if not r.cold:
                warm.append(r.ms)
                per_iter.append(r.ms / max(int(iters.max()), 1))
        if len(warm) < MIN_WARM:
            fail(f"{kind} closed loop: {len(warm)} warm batches, fewer "
                 f"than {MIN_WARM}")
        closed = {
            "batches": len(records), "warm_batches": len(warm),
            "warm_p50_ms": float(np.percentile(warm, 50)),
            "warm_ms": warm,
            "cold_ms": float(sum(r.ms for r in records if r.cold)),
            "iterations": [r.result.iterations[:len(r.sources)].tolist()
                           for r in records],
            "policies": sorted({r.policy for r in records}),
            "seconds": time.perf_counter() - t0,
        }
        if kind == "topk_paths":
            closed["warm_ms_per_iteration"] = per_iter
        gc.collect()
        torch.cuda.empty_cache()
        closed["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        peak_all = max(peak_all, torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        streams = []
        rc = serve.main(["--device", str(dev), "--dataset", "ldbc",
                         "--scale", str(SCALE), "--query-kind", kind,
                         "--rate", "20", *open_args],
                        on_stream=streams.append)
        torch.cuda.synchronize()
        if rc != 0 or len(streams) != 1:
            fail(f"serve --query-kind {kind} (open loop) exited {rc}")
        loop, arrivals = streams[0].loop, streams[0].arrivals
        graph, queries = (csr_w if kind == "topk_paths" else csr), []
        for a in arrivals:
            if "delta" in a:
                graph = apply_delta_csr(graph, a["delta"])
                continue
            queries.append((a["sources"], graph if graph is not csr_w
                            and kind == "topk_paths" else None))
        with ThreadPoolExecutor(ORACLE_THREADS) as pool:
            exps = list(pool.map(lambda q: expect(kind, *q), queries))
        n_q = len(queries)
        for i, (exp, _) in enumerate(exps):
            qid = f"q{i}"
            got = loop.results[qid]
            got = got if isinstance(got, dict) else {leaves[0]: got}
            compare(kind, got, exp, f"open-loop {qid}")
        st = loop.stats
        if st.completed != n_q:
            fail(f"{kind} open loop served {st.completed} of {n_q}")
        warm_q = sum(len(ts.warm_latencies_ms)
                     for ts in st.tenants.values())
        if st.batches - st.cold_batches < MIN_WARM:
            fail(f"{kind} open loop: {st.batches - st.cold_batches} warm "
                 f"batches, fewer than {MIN_WARM}")
        out[kind] = {"closed": closed, "open": {
            "queries": n_q, "batches": st.batches,
            "cold_batches": st.cold_batches, "warm_queries": warm_q,
            "warm_p50_ms": finite(st.p50()),
            "all_p50_ms": finite(st.p50(warm=False)),
            "deltas": len(loop.delta_reports),
            "apply_delta_ms": [r.ms for r in loop.delta_reports],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "seconds": time.perf_counter() - t0,
        }}
        # a p99 read off fewer than P99_MIN samples is only their largest
        if warm_q >= P99_MIN:
            out[kind]["open"]["warm_p99_ms"] = finite(st.p99())
        peak_all = max(peak_all, torch.cuda.max_memory_allocated())
        print(f"phase 3c: {kind}: " + json.dumps(out[kind]), flush=True)
        del loop, arrivals, streams, records
        gc.collect()
        torch.cuda.empty_cache()

    # a PPR batch run twice gives the same bits
    disp = QueryDispatcher(dev, csr, max_iters=512)
    src = np.random.default_rng(9).integers(0, n, 4).astype(np.int32)
    a = disp.query(src, query_kind="ppr").result
    b = disp.query(src, query_kind="ppr").result
    if not (torch.equal(a.iterations, b.iterations) and all(
            torch.equal(x, y) for x, y in zip(a.state, b.state))):
        fail("two runs of one PPR batch differ")
    del disp, a, b
    gc.collect()
    torch.cuda.empty_cache()
    out["peak_gb"] = max(peak_all, torch.cuda.max_memory_allocated()) / 1e9
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 3c: PPR repeat bitwise equal; min_dist "
          + json.dumps(out["min_dist"]) + f"; peak device memory "
          f"{out['peak_gb']:.3f} GB ({out['seconds']:.1f} s)", flush=True)
    return out


def stream_versions(csr, arrivals):
    """The graph versions of an open-loop schedule (the initial graph,
    then one a delta) and the ``(qid, sources)`` admitted under each: the
    schedule is in time order and qids count the submissions."""
    from repro_torch.graph.delta import apply_delta_csr

    graphs, by_version = [csr], [[]]
    for a in arrivals:
        if "delta" in a:
            graphs.append(apply_delta_csr(graphs[-1], a["delta"]))
            by_version.append([])
        else:
            qid = f"q{sum(len(q) for q in by_version)}"
            by_version[-1].append((qid, a["sources"]))
    return graphs, by_version


def check_versions(rname, results, graphs, by_version, oracle) -> None:
    """Every query's levels against the BFS of the graph version it was
    admitted under (``oracle`` serves version 0)."""
    n_queries = sum(len(q) for q in by_version)
    if len(results) != n_queries:
        fail(f"{rname}: {len(results)} of {n_queries} queries delivered")
    for v, queries in enumerate(by_version):
        if not queries:
            continue
        orc = oracle if v == 0 else BFSOracle(graphs[v])
        refs = orc.levels_of([src for _, src in queries])
        for (qid, src), ref in zip(queries, refs):
            if not np.array_equal(results[qid], ref):
                bad = int((results[qid] != ref).any(axis=1).sum())
                fail(f"{rname} {qid} (graph version {v}): levels of "
                     f"{bad} source(s) differ from the BFS oracle")


OVERLAP_ARRIVALS = 48  # 3b's backlog at most, every query due at once
OVERLAP_ORDER = (True, False, False, True)  # overlap on, off, off, on


def overlap_probe(loop) -> dict:
    """Wrap ``loop`` and its dispatcher to record, per batch, when it
    began, whether it was cold, its phase-1 ms, and when its phase 1
    ended (a done callback on the phase-1 future, which runs on the
    worker's thread as phase 1 returns); per finalize, when it started,
    its ms and the batch in flight."""
    disp = loop.dispatcher
    rec = {"begin": [], "p1_end": [], "cold": [], "phase1_ms": [],
           "fin": [], "inflight": None}
    begin, settle, finalize = (disp.begin_batch, disp.settle_batch,
                               loop._finalize_tail)

    def stamp(i):
        return lambda _: rec["p1_end"].__setitem__(i, time.perf_counter())

    def begin_batch(*args, **kwargs):
        compiles = disp.cache.compile_events
        t = time.perf_counter()
        inflight = begin(*args, **kwargs)
        i = len(rec["begin"])
        rec["begin"].append(t)
        rec["p1_end"].append(None)
        rec["cold"].append(compiles)
        rec["inflight"] = i
        phase1 = inflight.payload.get("phase1") if isinstance(
            inflight.payload, dict) else None
        if phase1 is not None:
            phase1.add_done_callback(stamp(i))
        return inflight

    def settle_batch(inflight):
        settled = settle(inflight)
        i = rec["inflight"]
        rec["cold"][i] = disp.cache.compile_events > rec["cold"][i]
        rec["phase1_ms"].append(settled.outcome.phase_ms["phase1"])
        return settled

    def finalize_tail(overlapped):
        t = time.perf_counter()
        finalize(overlapped)
        rec["fin"].append((overlapped, t, time.perf_counter() - t,
                           rec["inflight"] if overlapped else None))

    disp.begin_batch, disp.settle_batch = begin_batch, settle_batch
    loop._finalize_tail = finalize_tail
    return rec


def overlap_figures(rec: dict, t_end: float) -> dict:
    """Warm per-batch wall (begin to the next begin, the last batch to the
    stream's end), phase-1 and finalize ms (p50 of the warm batches), and
    how many finalizes started before the phase 1 in flight ended."""
    begins = rec["begin"] + [t_end]
    warm = [i for i, c in enumerate(rec["cold"]) if not c]
    wall = [(begins[i + 1] - begins[i]) * 1e3 for i in warm]
    p50 = lambda xs: float(np.percentile(xs, 50)) if xs else None
    hidden = sum(1 for o, t, _, i in rec["fin"]
                 if o and rec["p1_end"][i] is not None
                 and rec["p1_end"][i] > t)
    return {
        "batches": len(rec["begin"]),
        "warm_batches": len(warm),
        "warm_wall_ms_p50": p50(wall),
        "warm_phase1_ms_p50": p50([rec["phase1_ms"][i] for i in warm]),
        # begin to the worker's end of phase 1 (phase1_ms runs to the join)
        "warm_phase1_worker_ms_p50": p50([
            (rec["p1_end"][i] - rec["begin"][i]) * 1e3 for i in warm
            if rec["p1_end"][i] is not None]),
        "finalize_ms_p50": p50([ms * 1e3 for _, _, ms, _ in rec["fin"]]),
        "finalizes": len(rec["fin"]),
        "overlapped_finalizes": sum(1 for f in rec["fin"] if f[0]),
        "finalizes_before_phase1_end": hidden,
    }


def overlap_comparison(rname, disp, queries, oracle, launches,
                       kernel: str) -> dict:
    """Phase 3b's overlap comparison on ``disp``, an open-loop dispatcher:
    the first ``OVERLAP_ARRIVALS`` of an open run's seeded ``queries``
    (``serve.poisson_arrivals`` entries) as one backlog, all due at time
    0, served by ``ServingLoop.run_stream`` one query a batch
    (``max_batch_sources``) with overlap on and off in the order
    ``OVERLAP_ORDER``. Every run's results are bitwise the first's, and
    those ``oracle``'s (the BFS of ``disp``'s graph); each run must launch
    ``kernel`` and overlap every finalize but the last. Returns each run's
    ``overlap_figures``, stream seconds and launches."""
    from repro_torch.kernels.binned_pull import binned_pull as bp_mod
    from repro_torch.kernels.msbfs_extend import msbfs_extend as mx_mod
    from repro_torch.runtime.service import ServingLoop

    t0 = time.perf_counter()
    counters = {"binned_pull": bp_mod.fused_binned_pull,
                "msbfs_extend": mx_mod.msbfs_extend_blocks}
    arrivals = [{"t_ms": 0.0, "sources": q["sources"], "tenant": q["tenant"]}
                for q in queries[:OVERLAP_ARRIVALS]]
    spq = len(arrivals[0]["sources"])
    first, runs = None, []
    for overlap in OVERLAP_ORDER:
        for c in counters.values():
            c.launches = 0
        loop = ServingLoop(dispatcher=disp, overlap=overlap,
                           max_batch_sources=spq)
        rec = overlap_probe(loop)
        t1 = time.perf_counter()
        loop.run_stream(arrivals)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = {k: c.launches for k, c in counters.items()}
        if counts[kernel] <= 0:
            fail(f"3b overlap {rname}: never launched {kernel}")
        for k, v in counts.items():
            launches[k] += v
        if len(loop.results) != len(arrivals):
            fail(f"3b overlap {rname}: {len(loop.results)} of "
                 f"{len(arrivals)} queries served")
        if first is None:
            first = loop.results
            t_orc = time.perf_counter()
            refs = oracle.levels_of([a["sources"] for a in arrivals])
            for i, ref in enumerate(refs):
                if not np.array_equal(first[f"q{i}"], ref):
                    fail(f"3b overlap {rname}: q{i} differs from the BFS "
                         "oracle")
            oracle_s = time.perf_counter() - t_orc
        elif any(not np.array_equal(first[q], loop.results[q])
                 for q in first):
            fail(f"3b overlap {rname}: overlap {overlap} differs bitwise "
                 "from the first run")
        figs = overlap_figures(rec, t2)
        if overlap and figs["overlapped_finalizes"] != len(arrivals) - 1:
            fail(f"3b overlap {rname}: {figs['overlapped_finalizes']} "
                 f"finalizes overlapped of {len(arrivals) - 1}")
        runs.append({"overlap": overlap, **figs,
                     "occupancy": loop.stats.overlap_occupancy,
                     "stream_s": t2 - t1, "launches": counts})
    return {"runs": runs, "oracle_s": oracle_s,
            "seconds": time.perf_counter() - t0}


def phase_3b(dev, csr, oracle, launches) -> dict:
    """Phase 3b: the open-loop runs of ``serve.main`` with deltas
    mid-stream, each checked against the BFS of every query's graph
    version, then ``overlap_comparison`` on each run's dispatcher and
    last graph version. Prints a JSON line for each and returns them."""
    from repro_torch.kernels.binned_pull import binned_pull as bp_mod
    from repro_torch.kernels.msbfs_extend import msbfs_extend as mx_mod
    from repro_torch.launch import serve

    served = {}
    open_runs = {
        "open dopt_fused x8": (["--backend", "dopt_fused",
                                "--sources-per-batch", "8", "--tenants", "2",
                                "--rate", "20", "--arrivals", "120",
                                "--mutate-stream", "4", "--delta-edges",
                                "64"], "binned_pull"),
        "open recommend x64": (["--sources-per-batch", "64", "--rate", "20",
                                "--arrivals", "40", "--mutate-stream", "2",
                                "--delta-edges", "64"], "msbfs_extend"),
    }
    overlap = {}
    for rname, (extra, kernel) in open_runs.items():
        t0 = time.perf_counter()
        streams = []
        bp_mod.fused_binned_pull.launches = 0
        mx_mod.msbfs_extend_blocks.launches = 0
        rc = serve.main(["--device", str(dev), "--dataset", "ldbc",
                         "--scale", str(SCALE), *extra],
                        on_stream=streams.append)
        counts = {"binned_pull": bp_mod.fused_binned_pull.launches,
                  "msbfs_extend": mx_mod.msbfs_extend_blocks.launches}
        torch.cuda.synchronize()
        if rc != 0 or len(streams) != 1:
            fail(f"open-loop run {rname} exited {rc}")
        if counts[kernel] <= 0:
            fail(f"open-loop run {rname} never launched {kernel}: {counts}")
        for k, v in counts.items():
            launches[k] += v
        t1 = time.perf_counter()
        loop, arrivals = streams[0].loop, streams[0].arrivals
        graphs, by_version = stream_versions(csr, arrivals)
        st = loop.stats
        n_queries = sum(len(q) for q in by_version)
        if st.completed != n_queries:
            fail(f"{rname}: {st.completed} of {n_queries} queries served")
        check_versions(rname, loop.results, graphs, by_version, oracle)
        reps = loop.delta_reports
        if len(reps) != len(graphs) - 1 or (
                loop.dispatcher.csr.n_edges != graphs[-1].n_edges):
            fail(f"{rname}: {len(reps)} deltas applied of "
                 f"{len(graphs) - 1}")
        served[rname] = {
            "queries": n_queries,
            "batches": st.batches,
            "cold_batches": st.cold_batches,
            # None where no query was served by a warm batch
            "warm_p50_ms": finite(st.p50()),
            "warm_p99_ms": finite(st.p99()),
            "cold_ms": st.cold_ms,
            "all_p50_ms": finite(st.p50(warm=False)),
            "all_p99_ms": finite(st.p99(warm=False)),
            "sources_per_batch": sum(len(src) for q in by_version
                                     for _, src in q) / max(st.batches, 1),
            "overlap_occupancy": st.overlap_occupancy,
            "shed": st.shed,
            "deadline_misses": st.deadline_misses,
            "deltas": len(reps),
            "deltas_same_shape": sum(r.same_shape for r in reps),
            "engines_invalidated": sum(r.engines_invalidated for r in reps),
            "apply_delta_ms": [r.ms for r in reps],
            "delta_reports": [dataclasses.asdict(r) for r in reps],
            "stream_s": streams[0].wall_s,
            "launches": counts,
            "oracle_s": time.perf_counter() - t1,
            "seconds": time.perf_counter() - t0,
        }
        print(f"phase 3b: {rname}: " + json.dumps(served[rname]), flush=True)
        # the same backlog with overlap on and off, on this run's
        # dispatcher and its last graph version
        kind = rname.removeprefix("open ")
        overlap[kind] = overlap_comparison(
            kind, loop.dispatcher,
            [a for a in arrivals if "sources" in a], BFSOracle(graphs[-1]),
            launches, kernel)
        print(f"phase 3b: overlap {kind}: " + json.dumps(overlap[kind]),
              flush=True)
        del loop, arrivals, streams, graphs, by_version
        gc.collect()
        torch.cuda.empty_cache()

    return {"open": served, "overlap": overlap}


def star_csr(n, csr_from_edges):
    dsts = np.arange(1, n - 8)
    return csr_from_edges(n, np.zeros_like(dsts), dsts)


def hub_csr(n, csr_from_edges, seed=0):
    rng = np.random.default_rng(seed)
    live = n - max(n // 8, 1)
    v = np.arange(1, live)
    srcs = np.concatenate([v, v, np.zeros(4, np.int64)])
    fan = rng.choice(np.arange(1, live), size=4, replace=False)
    dsts = np.concatenate([np.zeros_like(v), 1 + (v % (live - 1)), fan])
    return csr_from_edges(n, srcs, dsts)


def swap_graph(csr_from_edges, GraphDelta):
    """Targets 0-9 have in-degree 3, targets 10-19 in-degree 5 (two degree
    buckets, no free slot); the delta gives node 0 two in-edges and takes
    two from node 10, so the two rows swap buckets. Weighted, for
    ``min_dist``."""
    src = np.array([20 + (t * 5 + j) % 20 for t in range(20)
                    for j in range(3 if t < 10 else 5)])
    dst = np.array([t for t in range(20) for _ in range(3 if t < 10 else 5)])
    w = np.random.default_rng(5).uniform(0.1, 2.0, len(src))
    csr = csr_from_edges(40, src, dst, weights=w.astype(np.float32))
    new_src = [s for s in range(20, 40) if s not in set(src[dst == 0])][:2]
    return csr, GraphDelta(add_src=new_src, add_dst=[0, 0],
                           del_src=src[dst == 10][:2], del_dst=[10, 10],
                           add_weights=[0.5, 1.5])


def tile_swap_graph(csr_from_edges, GraphDelta, erdos_renyi):
    """A lone edge in tile (0, 2) and none in tile (2, 2) of a 300-node
    graph (3x3 tiles of 128): the delta empties the first, freeing its
    slot, and the second claims it."""
    base = erdos_renyi(120, 3.0, seed=2)
    s, t = base.edge_list()
    csr = csr_from_edges(300, np.concatenate([s, [5, 130]]),
                         np.concatenate([t, [290, 10]]))
    return csr, GraphDelta(add_src=[260], add_dst=[270], del_src=[5],
                           del_dst=[290])


# -- phase 7: ranks --------------------------------------------------------

RANKS = 4  # processes sharing the card over gloo
#: a rank's intra-op threads: its share of the cores this process may use
#: (the ranks are alone on the machine)
RANK_THREADS = max(1, len(os.sched_getaffinity(0)) // RANKS)
RANKS_TIMEOUT_S = 600  # the whole rank group, or it fails
TILE = 128  # block_mxu tile size


def _swap_delta(csr, GraphDelta, rng, n_swaps=32):
    """Double edge swaps (u->v, x->y) => (u->y, x->v), v and y in one
    column block: every degree and every tile's presence stays, so every
    structure folds in place (2 x ``n_swaps`` inserts and deletes)."""
    n = csr.n_nodes
    s, t = (a.astype(np.int64) for a in csr.edge_list())
    keys = np.sort(s * n + t)
    order = np.argsort(t // TILE, kind="stable")
    cb = (t // TILE)[order]
    used, dels, adds = set(), [], []
    while len(dels) < 2 * n_swaps:
        i = int(rng.integers(0, len(s)))
        lo, hi = np.searchsorted(cb, [t[i] // TILE, t[i] // TILE + 1])
        j = int(order[rng.integers(lo, hi)])
        (u, v), (x, y) = (int(s[i]), int(t[i])), (int(s[j]), int(t[j]))
        new = [(u, y), (x, v)]
        k = np.array([a * n + b for a, b in new])
        at = np.minimum(np.searchsorted(keys, k), len(keys) - 1)
        if (u == x or v == y or (keys[at] == k).any()
                or any(e in used for e in [(u, v), (x, y), *new])):
            continue
        used.update([(u, v), (x, y), *new])
        dels += [(u, v), (x, y)]
        adds += new
    (ds, dd), (a_s, ad) = zip(*dels), zip(*adds)
    return GraphDelta(add_src=a_s, add_dst=ad, del_src=ds, del_dst=dd)


def _rebin_delta(csr, GraphDelta, rng):
    """In-edges moved from a row of in-degree b to one of in-degree a (1
    <= a, b - a in [2, 6]), both in the first column block (shard 0 of
    every split), from the same sources: the two rows trade degree
    buckets, every out-degree and tile stays."""
    rev = csr.reverse()
    indeg = np.diff(rev.indptr)[:TILE]
    ins = lambda v: set(rev.indices[rev.indptr[v]:rev.indptr[v + 1]]
                        .tolist())
    for t in np.argsort(indeg, kind="stable"):
        for t2 in range(TILE):
            a, b = int(indeg[t]), int(indeg[t2])
            if a < 1 or not 2 <= b - a <= 6:
                continue
            movers = sorted(ins(t2) - ins(t))[: b - a]
            if len(movers) == b - a:
                return GraphDelta(add_src=movers, add_dst=[t] * len(movers),
                                  del_src=movers, del_dst=[t2] * len(movers))
    raise RuntimeError("no pair of rows to rebin")


def _overflow_delta(csr, GraphDelta, rng):
    """New out-edges for the node of highest out-degree, one past its
    forward ELL width: every bundle's forward ELL is rebuilt."""
    u = int(np.argmax(csr.degrees))
    width = -(-int(csr.degrees[u]) // 8) * 8
    have = np.zeros(csr.n_nodes, bool)
    have[csr.neighbors(u)] = True
    new = np.flatnonzero(~have)[: width - int(csr.degrees[u]) + 1]
    return GraphDelta(add_src=np.full(len(new), u), add_dst=new)


def _tiles_delta(csr, GraphDelta, rng, n_pad):
    """One edge into every empty tile of the rows of shard 0 of the
    (2, 2) engine part's two-way split (``n_pad`` rows padded for four):
    that shard's tile list overflows and the tiles are rebuilt."""
    n = csr.n_nodes
    s, t = csr.edge_list()
    have = set(np.unique((s.astype(np.int64) // TILE) * n + t // TILE)
               .tolist())
    adds = []
    for rb in range(-(-min(n_pad // 2, n) // TILE)):
        for cb in range(-(-n // TILE)):
            if rb * n + cb not in have:
                adds.append((rb * TILE, min(cb * TILE, n - 1)))
    a_s, a_d = zip(*adds) if adds else ((), ())
    return GraphDelta(add_src=a_s, add_dst=a_d)


def phase7_deltas(csr, GraphDelta, apply_delta_csr, n_pad):
    """The engine part's deltas, each built on the graph the ones before
    it left: ``[(name, delta)]`` and the graph after each."""
    rng = np.random.default_rng(31)
    out, graphs = [], []
    for name, make in (
            ("same_shape", _swap_delta), ("rebin", _rebin_delta),
            ("ell_overflow", _overflow_delta),
            ("tiles_full", lambda g, D, r: _tiles_delta(g, D, r, n_pad))):
        d = make(csr, GraphDelta, rng)
        out.append((name, d))
        csr = apply_delta_csr(csr, d)
        graphs.append(csr)
    return out, graphs


def _digest(a: np.ndarray) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def host_rss_gb() -> float:
    """This process's resident host memory now (``/proc/self/statm``)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9


def work_bound(nbytes: int, ops: int) -> tuple:
    """(bound ms, "bytes" or "operations"): ``nbytes`` at the card's
    memory rate against ``ops`` int8 operations at its peak rate."""
    b, o = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return max(b, o) * 1e3, ("bytes" if b >= o else "operations")


def pull_bound(pack, open_rows, in_bytes: int, out_bytes: int,
               lanes: int = 1) -> tuple:
    """``work_bound`` of one ``binned_pull`` call on ``pack``, counted as
    phase 4 counts it: the slab ids of the rows it reads (``open_rows``
    of the local rows, 4 bytes a slot), its inputs (``in_bytes``),
    ``perm_pad`` and its output, each once; a compare a lane a slot."""
    from repro_torch.kernels.binned_pull.ops import launch_record

    plan = launch_record(pack).plan
    wpos = np.zeros(plan.rbp, np.int64)
    for b, w in enumerate(plan.widths):
        wpos[plan.astarts[b]: plan.astarts[b] + plan.rows_pad[b]] = w
    widths = wpos[pack.inv_pad[0].cpu().numpy()]
    slots = int(widths[np.asarray(open_rows, bool)].sum())
    return work_bound(4 * slots + in_bytes + 4 * plan.rbp + out_bytes,
                      slots * lanes)


def extend_bound(blocks, brows, bcols, lanes, g_out: int) -> tuple:
    """``work_bound`` of one ``msbfs_extend`` call, counted as phase 4
    counts it: the tiles under an active source stripe, every tile's
    coordinates, the lane stripes in and ``g_out`` row blocks of lanes
    out; a multiply-add a lane a tile entry."""
    bsz, n_lanes = int(blocks.shape[-1]), int(lanes.shape[-1])
    act = (lanes != 0).any(dim=2).any(dim=1)
    active = int((act[brows.long()] & (bcols < g_out)).sum())
    nbytes = (active * bsz * bsz + 8 * int(blocks.shape[0]) + lanes.numel()
              + g_out * bsz * n_lanes)
    return work_bound(nbytes, active * 2 * bsz * bsz * n_lanes)


def phase7_engine_cases(mesh, g, n_pad, bundle, backends, src8, src64,
                        into: dict, levels: dict | None, tag: str = ""):
    """Phase 7's engine cases on one structure set ``g``: nTkS and nTkMS
    on each backend in both state layouts, each case's own kernel
    launches counted alone. Fills ``into`` with each case's digest,
    iterations, trips and launches (and ``levels``, on rank 0); returns
    the replicated cases' levels, the kernel checks' inputs."""
    from repro_torch.core import (
        build_engine,
        pad_sources,
        policy_ntkms,
        policy_ntks,
    )
    from repro_torch.kernels.binned_pull import binned_pull as bp_mod
    from repro_torch.kernels.msbfs_extend import msbfs_extend as mx_mod

    inputs = {}
    for be in backends:
        for pname, pol, srcs, ec in (
                ("ntks", policy_ntks(), src8, "sp_lengths"),
                ("ntkms", policy_ntkms(), src64, "msbfs_lengths")):
            for lay in ("replicated", "sharded"):
                morsels = pad_sources(srcs, 2, pol.lanes, n_pad)
                eng = build_engine(mesh, pol, ec, n_pad, state_layout=lay,
                                   extend=be)
                # this case's engine launches alone
                bp_mod.fused_binned_pull.launches = 0
                mx_mod.msbfs_extend_blocks.launches = 0
                tc = time.perf_counter()
                res = eng(g, morsels)
                torch.cuda.synchronize()
                case_ms = (time.perf_counter() - tc) * 1e3
                launched = {"binned_pull": bp_mod.fused_binned_pull.launches,
                            "msbfs_extend":
                                mx_mod.msbfs_extend_blocks.launches}
                lv = res.state.levels.cpu().numpy()
                its = res.iterations.numpy()
                per = len(its) // 2
                d = mesh.coord("data")
                # this rank's morsels: one extension a trip each
                trips = int(its[d * per:(d + 1) * per].sum())
                key = f"{tag}{pname}/{be}/{lay}"
                into[key] = {
                    "digest": _digest(lv), "iterations": its.tolist(),
                    "trips": trips, "launches": launched, "ms": case_ms}
                if levels is not None:
                    levels[key] = lv
                if lay == "replicated" and pname not in inputs:
                    inputs[pname] = lv
    return inputs


def phase7_delta_part(mesh, csr, deltas, src8, src64,
                      levels: dict | None) -> list:
    """The (2, 2) engine part on operands graph deltas folded: a
    dispatcher's nTkS bundles of the engine cases' two structure sets;
    each delta folded by every rank into its own shards, then every
    engine case re-run and ``binned_pull`` (all five ops) and
    ``msbfs_extend`` held against their plain versions on the folded
    shard pack and tiles. Returns one entry a delta."""
    from repro_torch.core import as_spec, policy_ntks
    from repro_torch.kernels.binned_pull.binned_pull import LANE_OPS, OPS
    from repro_torch.kernels.binned_pull.ops import binned_pull
    from repro_torch.kernels.msbfs_extend.ops import extend_blocks
    from repro_torch.runtime.dispatch import QueryDispatcher

    dev = mesh.device
    sets = (("dopt_fused", ("dopt_fused", "pull_binned_fused")),
            ("block_mxu", ("block_mxu",)))
    dq = QueryDispatcher(mesh, csr, max_iters=64)
    for bundle, _ in sets:
        dq._graph_for(policy_ntks(), as_spec(bundle))
    steps = []
    for step, (dname, d) in enumerate(deltas, 1):
        torch.cuda.reset_peak_memory_stats()
        r = dq.apply_delta(d)
        entry = {
            "delta": dname, "adds": r.n_adds, "dels": r.n_dels,
            "apply_delta_ms": r.ms, "slowest_rank_ms": r.ms_max,
            "wire_bytes": r.wire_bytes,
            "structures_changed": r.structures_changed,
            "structures_rebuilt": r.structures_rebuilt,
            "binned_moves": r.binned_moves,
            "engines_invalidated": r.engines_invalidated,
            "rebuilt": sorted({f"{'+'.join(k[0])}/{s}"
                               for k, f in r.folds
                               for s, v in f.reshaped.items() if v}),
            "cases": {}, "kernels": {},
        }
        for bundle, backends in sets:
            b = dq._graph_for(policy_ntks(), as_spec(bundle))
            g, n_pad = b.ops, b.n_pad
            inputs = phase7_engine_cases(
                mesh, g, n_pad, bundle, backends, src8, src64,
                entry["cases"], levels, tag=f"delta{step}/")
            rows = g.fwd.n_nodes
            lo = mesh.coord("model") * rows
            if bundle == "dopt_fused":
                pack = g.rev_binned_pack
                lv1 = inputs["ntks"][0]
                lanes = inputs["ntkms"][0]
                dense = (torch.tensor((lv1 == 2).astype(np.uint8),
                                      device=dev),
                         torch.tensor(((lv1 >= 0) & (lv1 <= 2))[lo:lo + rows]
                                      .astype(np.uint8), device=dev))
                lane = (torch.tensor((lanes == 2).astype(np.uint8),
                                     device=dev),
                        torch.tensor((lanes <= 2)[lo:lo + rows]
                                     .astype(np.uint8), device=dev))
                dist = (torch.tensor(np.where(lv1 >= 0, lv1, np.inf)
                                     .astype(np.float32), device=dev), None)
                for op in OPS:
                    a, v = (lane if op in LANE_OPS else
                            dist if op == "min_dist" else dense)
                    got = binned_pull(pack, a, v, op=op)
                    exp = binned_pull(pack, a, v, op=op, use_ref=True)
                    torch.cuda.synchronize()
                    entry["kernels"][f"binned_pull/{op}"] = bool(
                        torch.equal(got, exp))
            else:
                sb = g.blocks
                bsz = sb.block_size
                loc = torch.tensor(
                    (inputs["ntkms"][0][lo:lo + rows] == 2).astype(np.uint8),
                    device=dev).view(rows // bsz, bsz, 64)
                tiles = (sb.blocks[0], sb.block_rows[0], sb.block_cols[0])
                got = extend_blocks(*tiles, loc, g_out=n_pad // bsz)
                exp = extend_blocks(*tiles, loc, g_out=n_pad // bsz,
                                    use_ref=True)
                torch.cuda.synchronize()
                entry["kernels"]["msbfs_extend"] = bool(torch.equal(got, exp))
            del g
        entry["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        # after the fold: the rank's host mirrors are resident
        entry["host_rss_gb"] = host_rss_gb()
        steps.append(entry)
    del dq
    gc.collect()
    torch.cuda.empty_cache()
    return steps


def phase7_rank(rank: int, world: int, scale: float, src8, src64,
                deltas) -> dict:
    """One of the ranks that share the card over gloo: the engines on a
    (2, 2) mesh in both state layouts, each kernel at its shard shape
    against its plain version, then ``serve`` on (1, 4), closed loop and
    open loop. Returns its report; rank 0 also the served levels."""
    t_entry = time.perf_counter()
    from repro_torch.core import policy_ntks, prepare_graph
    from repro_torch.graph.generators import PAPER_DATASETS
    from repro_torch.kernels.binned_pull import binned_pull as bp_mod
    from repro_torch.kernels.binned_pull.ops import binned_pull
    from repro_torch.kernels.msbfs_extend import msbfs_extend as mx_mod
    from repro_torch.kernels.msbfs_extend.ops import extend_blocks
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    csr = PAPER_DATASETS["ldbc"](scale)
    mesh = make_mesh((2, 2), ("data", "model"), dev)
    rep = {"rank": rank, "coords": [mesh.coord("data"),
                                    mesh.coord("model")], "cases": {}}
    levels = {}
    torch.cuda.reset_peak_memory_stats()
    mesh.wire.reset()
    t0 = time.perf_counter()
    shapes, kernel_checks = {}, {}
    check_launches = {"binned_pull": 0, "msbfs_extend": 0}

    def read_launches(into):
        into["binned_pull"] += bp_mod.fused_binned_pull.launches
        into["msbfs_extend"] += mx_mod.msbfs_extend_blocks.launches

    # one bundle a structure set, as run_recursive_query builds it:
    # dopt_fused and pull_binned_fused scan one bundle, block_mxu another
    for bundle, backends in (("dopt_fused", ("dopt_fused",
                                             "pull_binned_fused")),
                             ("block_mxu", ("block_mxu",))):
        tb = time.perf_counter()
        g, n_pad = prepare_graph(csr, mesh, policy_ntks(), extend=bundle)
        torch.cuda.synchronize()
        rep[f"build_s/{bundle}"] = time.perf_counter() - tb
        inputs = phase7_engine_cases(mesh, g, n_pad, bundle, backends, src8,
                                     src64, rep["cases"],
                                     levels if rank == 0 else None)
        # each kernel at this rank's shard shape against its plain version;
        # these launches are counted apart from the engines'
        bp_mod.fused_binned_pull.launches = 0
        mx_mod.msbfs_extend_blocks.launches = 0
        rows = g.fwd.n_nodes
        lo = mesh.coord("model") * rows
        if bundle == "dopt_fused":
            pack = g.rev_binned_pack
            lv1 = inputs["ntks"][0]
            gsrc = torch.tensor((lv1 == 2).astype(np.uint8), device=dev)
            vloc = torch.tensor(((lv1 >= 0) & (lv1 <= 2))[lo:lo + rows]
                                .astype(np.uint8), device=dev)
            lanes = inputs["ntkms"][0]  # [n_pad, 64] u8, 255 unreached
            gl = torch.tensor((lanes == 2).astype(np.uint8), device=dev)
            vl = torch.tensor((lanes <= 2)[lo:lo + rows].astype(np.uint8),
                              device=dev)
            for op, a, v, out_bytes in (("reach", gsrc, vloc, rows),
                                        ("reach_lanes", gl, vl, rows * 64),
                                        ("min_parent_lanes", gl, vl,
                                         4 * rows * 64)):
                got = binned_pull(pack, a, v, op=op)
                exp = binned_pull(pack, a, v, op=op, use_ref=True)
                torch.cuda.synchronize()
                open_rows = (v == 0).reshape(rows, -1).any(dim=1)
                bound_ms, bound_by = pull_bound(
                    pack, open_rows.cpu().numpy(), a.numel() + v.numel(),
                    out_bytes, lanes=a.numel() // a.shape[0])
                kernel_checks[f"binned_pull/{op}"] = {
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "equal": bool(torch.equal(got, exp)),
                    "ms": time_ms(lambda: binned_pull(pack, a, v, op=op),
                                  reps=10, rounds=3),
                    "plain_ms": time_ms(lambda: binned_pull(
                        pack, a, v, op=op, use_ref=True), reps=2, rounds=1),
                }
            shapes["binned_pull"] = (
                f"pack rows_local {pack.rows_local} of n_out {n_pad} (row "
                f"base {lo}), {len(pack.slabs)} slabs, "
                f"{pack.capacity_slots} slots")
        else:
            sb = g.blocks
            bsz = sb.block_size
            lanes = inputs["ntkms"][0]
            loc = torch.tensor((lanes[lo:lo + rows] == 2).astype(np.uint8),
                               device=dev).view(rows // bsz, bsz, 64)
            tiles = (sb.blocks[0], sb.block_rows[0], sb.block_cols[0])
            got = extend_blocks(*tiles, loc, g_out=n_pad // bsz)
            exp = extend_blocks(*tiles, loc, g_out=n_pad // bsz,
                                use_ref=True)
            torch.cuda.synchronize()
            bound_ms, bound_by = extend_bound(*tiles, loc, n_pad // bsz)
            kernel_checks["msbfs_extend"] = {
                "bound_ms": bound_ms, "bound_by": bound_by,
                "equal": bool(torch.equal(got, exp)),
                "ms": time_ms(lambda: extend_blocks(
                    *tiles, loc, g_out=n_pad // bsz), reps=10, rounds=3),
                "plain_ms": time_ms(lambda: extend_blocks(
                    *tiles, loc, g_out=n_pad // bsz, use_ref=True), reps=1,
                    rounds=1),
            }
            shapes["msbfs_extend"] = (
                f"{int(sb.blocks.shape[1])} tiles of {bsz}x{bsz} int8 over "
                f"{rows // bsz} local row blocks, g_out {n_pad // bsz}")
        read_launches(check_launches)
        del g
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    rep["engines_s"] = time.perf_counter() - t0
    steps = sum(c["trips"] for c in rep["cases"].values())
    rep["launches"] = {k: sum(c["launches"][k] for c in rep["cases"].values())
                       for k in ("binned_pull", "msbfs_extend")}
    rep["check_launches"] = check_launches
    rep["shapes"] = shapes
    rep["kernels"] = kernel_checks
    rep["steps"] = steps
    rep["wire"] = {"calls": mesh.wire.calls, "bytes": mesh.wire.bytes,
                   "staged_bytes": mesh.wire.staged_bytes,
                   "ms": mesh.wire.ms,
                   "ms_per_iteration": mesh.wire.ms / max(steps, 1)}
    rep["engines_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # the same cases on operands each rank folds graph deltas into
    td = time.perf_counter()
    rep["deltas"] = phase7_delta_part(mesh, csr, deltas, src8, src64,
                                      levels if rank == 0 else None)
    rep["deltas_s"] = time.perf_counter() - td
    # serve on JAX serve's (1, 4) mesh: rank 0 leads, the others follow
    served = {}
    common = ["--device", "cuda:0", "--dataset", "ldbc", "--scale",
              str(scale)]
    for sname, extra in (
            ("closed dopt_fused x8", ["--closed-loop", "--backend",
                                      "dopt_fused", "--sources-per-batch",
                                      "8", "--batches", "3"]),
            ("closed recommend x64", ["--closed-loop",
                                      "--sources-per-batch", "64",
                                      "--batches", "2"]),
            ("open dopt_fused x8", ["--backend", "dopt_fused",
                                    "--sources-per-batch", "8",
                                    "--arrivals", "24", "--rate", "20",
                                    "--mutate-stream", "2"]),
            ("open recommend x64", ["--sources-per-batch", "64",
                                    "--arrivals", "12", "--rate", "20",
                                    "--mutate-stream", "1"])):
        torch.cuda.reset_peak_memory_stats()
        bp_mod.fused_binned_pull.launches = 0
        mx_mod.msbfs_extend_blocks.launches = 0
        batches, streams, finalized = [], [], {}
        ts = time.perf_counter()
        rc = serve.main(
            common + extra, on_batch=lambda r: batches.append(
                (r.sources, r.policy, r.result.state.levels.cpu().numpy(),
                 r.ms, r.cold)), on_stream=streams.append,
            on_outcome=lambda seq, o: finalized.__setitem__(
                seq, _digest(o.result.state.levels.cpu().numpy())))
        if rc != 0:
            raise RuntimeError(f"serve {sname} exited {rc}")
        entry = {
            "launches": {
                "binned_pull": bp_mod.fused_binned_pull.launches,
                "msbfs_extend": mx_mod.msbfs_extend_blocks.launches},
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "seconds": time.perf_counter() - ts,
            # every rank's finalized batches (a follower's replays)
            "finalized": finalized,
        }
        if rank == 0 and batches:
            entry["batches"] = batches
        if rank == 0 and streams:
            loop = streams[0].loop
            entry["arrivals"] = streams[0].arrivals
            entry["results"] = dict(loop.results)
            entry["warm_p50_ms"] = finite(loop.stats.p50())
            entry["batches_n"] = loop.stats.batches
            entry["delta_reports"] = [
                {"version": r.version, "ms": r.ms,
                 "slowest_rank_ms": r.ms_max, "wire_bytes": r.wire_bytes,
                 "structures_changed": r.structures_changed,
                 "structures_rebuilt": r.structures_rebuilt,
                 "binned_moves": r.binned_moves,
                 "engines_invalidated": r.engines_invalidated}
                for r in loop.delta_reports]
        served[sname] = entry
        gc.collect()
        torch.cuda.empty_cache()
    rep["served"] = served
    rep["levels"] = levels
    rep["setup_s"] = t0 - t_entry
    rep["wall_s"] = time.perf_counter() - t_entry
    return rep


def phase7_nccl(rank: int, world: int, scale: float) -> dict:
    """A world of one NCCL rank on the card: ``serve --closed-loop``. It
    shows only that the NCCL process group comes up and the one-rank
    serve runs inside it; on a mesh of one rank every collective is the
    identity, so no collective of the port runs on NCCL here."""
    import torch.distributed as dist

    from repro_torch.launch import serve

    batches = []
    rc = serve.main(["--closed-loop", "--device", "cuda:0", "--dataset",
                     "ldbc", "--scale", str(scale), "--backend",
                     "dopt_fused", "--sources-per-batch", "8", "--batches",
                     "3"],
                    on_batch=lambda r: batches.append(
                        (r.sources, r.result.state.levels.cpu().numpy())))
    return {"rc": rc, "backend": dist.get_backend(), "batches": batches}


def check_case_launches(rank: int, what: str, cases: dict) -> None:
    """The engines' own launches, apart from the checks': a fused pull or
    ``block_mxu`` case launches its kernel on every trip, ``dopt_fused``
    on its pull trips (at least once over its cases)."""
    dopt_pulls = 0
    for key, case in cases.items():
        be = key.split("/")[-2]
        k = {"pull_binned_fused": "binned_pull",
             "block_mxu": "msbfs_extend"}.get(be)
        if k is not None and case["launches"][k] < max(case["trips"], 1):
            fail(f"phase 7 rank {rank} {what}{key}: {k} launched "
                 f"{case['launches'][k]} times in {case['trips']} trips")
        if be == "dopt_fused":
            dopt_pulls += case["launches"]["binned_pull"]
    if dopt_pulls <= 0:
        fail(f"phase 7 rank {rank} {what}: dopt_fused never launched "
             "binned_pull")


def phase_7(csr, oracle) -> dict:
    """Four ranks share the card over gloo (host-staged messages); then a
    world-size-1 NCCL run of ``serve --closed-loop``."""
    from repro_torch.graph.generators import pick_sources
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.runtime.service import unpack_levels

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.graph.delta import GraphDelta, apply_delta_csr
    from repro_torch.graph.partition import padded_n

    src8 = np.asarray(pick_sources(csr, 8, seed=300), np.int32)
    src64 = np.asarray(pick_sources(csr, 64, seed=301), np.int32)
    # the engine part's deltas; block_mxu's rows pad for the four ranks
    deltas, graphs = phase7_deltas(csr, GraphDelta, apply_delta_csr,
                                   padded_n(csr.n_nodes, RANKS, TILE))
    t_ranks = time.perf_counter()
    reports = run_ranks(phase7_rank, RANKS, (SCALE, src8, src64, deltas),
                        backend="gloo", timeout_s=RANKS_TIMEOUT_S,
                        threads=RANK_THREADS)
    ranks_s = time.perf_counter() - t_ranks
    n = csr.n_nodes
    refs = {"": (oracle.levels(src8), oracle.levels(src64))}
    for step, g in enumerate(graphs, 1):
        orc = BFSOracle(g)
        refs[f"delta{step}/"] = (orc.levels(src8), orc.levels(src64))
    lead = reports[0]
    for key, lv in lead["levels"].items():
        tag, case = (key.split("/", 1)[0] + "/", key.split("/", 1)[1]) \
            if key.startswith("delta") else ("", key)
        packed = case.startswith("ntkms")
        ref = refs[tag][1 if packed else 0]
        got = unpack_levels(lv, {"q": (0, len(ref))}, n, packed)["q"]
        if not np.array_equal(got, ref):
            fail(f"phase 7 {key}: levels differ from the BFS oracle")
        for r in reports[1:]:
            cases = r["cases"] if not tag else r["deltas"][
                int(tag[5:-1]) - 1]["cases"]
            mine = lead["cases"] if not tag else lead["deltas"][
                int(tag[5:-1]) - 1]["cases"]
            if cases[key]["digest"] != mine[key]["digest"]:
                fail(f"phase 7 {key}: rank {r['rank']} holds other levels")
    if len(lead["levels"]) != 12 * (1 + len(deltas)):
        fail(f"phase 7: {len(lead['levels'])} engine cases checked")
    for r in reports:
        for kname, chk in r["kernels"].items():
            if not chk["equal"]:
                fail(f"phase 7 rank {r['rank']}: {kname} at the shard shape "
                     "differs from its plain version")
        check_case_launches(r["rank"], "", r["cases"])
        for step, entry in enumerate(r["deltas"], 1):
            bad = [k for k, ok in entry["kernels"].items() if not ok]
            if bad or len(entry["kernels"]) != 6:
                fail(f"phase 7 rank {r['rank']} delta {step}: {bad} on the "
                     f"folded shard differ from their plain versions")
            check_case_launches(r["rank"], f"delta {step} ", entry["cases"])
            if r["deltas"][step - 1]["rebuilt"] != \
                    lead["deltas"][step - 1]["rebuilt"]:
                fail(f"phase 7 delta {step}: ranks rebuilt other structures")
        if r["wire"]["staged_bytes"] <= 0:
            fail(f"phase 7 rank {r['rank']} staged nothing over gloo")
    # the deltas reshape what they were built to: nothing for the first
    # two, every forward ELL, then the tiles
    rebuilt = [set(e["rebuilt"]) for e in lead["deltas"]]
    if (rebuilt[0] or rebuilt[1] or lead["deltas"][1]["binned_moves"] <= 0
            or not {"model/fwd"} <= rebuilt[2]
            or "model/blocks" not in rebuilt[3]):
        fail(f"phase 7 deltas rebuilt {rebuilt}, moves "
             f"{[e['binned_moves'] for e in lead['deltas']]}")
    for sname, entry in lead["served"].items():
        if "batches" in entry:
            for srcs, pol, lv, _, _ in entry["batches"]:
                got = unpack_levels(lv, {"q": (0, len(srcs))}, n,
                                    pol == "ntkms")["q"]
                if not np.array_equal(got, oracle.levels(srcs)):
                    fail(f"phase 7 serve {sname}: levels differ from BFS")
        if "results" in entry:
            sgraphs, by_version = stream_versions(csr, entry["arrivals"])
            want = int(sname.startswith("open dopt")) + 1
            if len(entry["delta_reports"]) != want:
                fail(f"phase 7 serve {sname}: "
                     f"{len(entry['delta_reports'])} deltas applied")
            check_versions(f"phase 7 serve {sname}", entry["results"],
                           sgraphs, by_version, oracle)
        for r in reports[1:]:
            if r["served"][sname]["finalized"] != entry["finalized"]:
                fail(f"phase 7 serve {sname}: rank {r['rank']} finalized "
                     "other batches than rank 0")
    kernel_launch = {"binned_pull": 0, "msbfs_extend": 0}
    for r in reports:
        for sname, entry in r["served"].items():
            for k, v in entry["launches"].items():
                kernel_launch[k] += v
    if min(kernel_launch.values()) <= 0:
        fail(f"phase 7 serve runs launched no kernel: {kernel_launch}")
    t1 = time.perf_counter()
    checks_s = t1 - t_ranks - ranks_s
    (nccl,) = run_ranks(phase7_nccl, 1, (SCALE,), backend="nccl",
                        timeout_s=RANKS_TIMEOUT_S, threads=RANK_THREADS)
    if nccl["rc"] != 0 or nccl["backend"] != "nccl":
        fail(f"phase 7 NCCL run: {nccl['rc']}, {nccl['backend']}")
    for srcs, lv in nccl["batches"]:
        got = unpack_levels(lv, {"q": (0, len(srcs))}, n, False)["q"]
        if not np.array_equal(got, oracle.levels(srcs)):
            fail("phase 7 NCCL serve: levels differ from the BFS oracle")
    summary = {"ranks": [], "nccl_s": time.perf_counter() - t1,
               "prep_s": t_ranks - t0, "ranks_s": ranks_s,
               "checks_s": checks_s}
    for r in reports:
        line = {
            "rank": r["rank"], "coords": r["coords"],
            "launches": r["launches"],
            "case_launches": {k: {**c["launches"], "trips": c["trips"]}
                              for k, c in r["cases"].items()},
            "check_launches": r["check_launches"], "shapes": r["shapes"],
            "kernels": r["kernels"], "wire": r["wire"],
            "steps": r["steps"], "engines_s": r["engines_s"],
            "build_s": {k[8:]: v for k, v in r.items()
                        if k.startswith("build_s/")},
            "engines_peak_gb": r["engines_peak_gb"],
            "deltas": [{k: v for k, v in e.items()
                        if k not in ("cases", "kernels")}
                       for e in r["deltas"]],
            "delta_case_launches": [
                {k: {**c["launches"], "trips": c["trips"]}
                 for k, c in e["cases"].items()} for e in r["deltas"]],
            "deltas_s": r["deltas_s"],
            "setup_s": r["setup_s"], "wall_s": r["wall_s"],
            "serve": {s: {"launches": e["launches"],
                          "peak_gb": e["peak_gb"], "seconds": e["seconds"]}
                      for s, e in r["served"].items()},
        }
        summary["ranks"].append(line)
        print(f"phase 7: rank {r['rank']} " + json.dumps(line), flush=True)
    lead_serve = {}
    for sname, entry in lead["served"].items():
        if "batches" in entry:
            warm = [ms for _, _, _, ms, cold in entry["batches"] if not cold]
            lead_serve[sname] = {
                "batches": len(entry["batches"]),
                "policies": sorted({p for _, p, _, _, _ in
                                    entry["batches"]}),
                "warm_ms": warm}
        else:
            lead_serve[sname] = {"queries": len(entry["results"]),
                                 "batches": entry["batches_n"],
                                 "warm_p50_ms": entry["warm_p50_ms"],
                                 "deltas": entry["delta_reports"]}
    summary["serve"] = lead_serve
    summary["seconds"] = time.perf_counter() - t0
    print("phase 7: " + json.dumps({
        "serve": lead_serve, "serve_launches": kernel_launch,
        "nccl_batches": len(nccl["batches"]), "nccl_s": summary["nccl_s"],
        "prep_s": summary["prep_s"], "ranks_s": ranks_s,
        "checks_s": checks_s, "seconds": summary["seconds"]}), flush=True)
    return summary


LM_ARCH = "minicpm-2b"  # launch/train.py's default arch: 40 global MHA layers
LM_PROMPTS = (4, 4096)  # prefill_32k's 32 x 32,768 cut to 4 x 4,096
LM_STEPS = 32  # greedy decode steps: decode_32k's cache cut to 4 x 4,128
LM_F32_PROMPTS = 2  # the float32 repeat serves the first 2 prompts
LM_LONG = 32768  # prefill_32k's own length, one sequence
LM_COS = 0.999  # bfloat16 kernel route against the scan route, per row
LM_F32_TOL = 1e-4  # float32 routes, relative to the largest magnitude


def lm_config():
    from repro_torch.configs import base

    return base.get(LM_ARCH).full_config()


def lm_work(cfg, n_params: int, b: int, s: int, max_seq: int):
    """(operations, bytes) of a prefill of ``[b, s]`` into a cache of
    ``max_seq`` slots, and of one decode step over that whole cache: each
    weight read once, the cache written (prefill) or read (decode) once,
    the logits written once; projections and MLP as 2 operations a
    weight a token, causal attention as 4 * d_head a (query, key) pair a
    head, the unembedding for the last position only."""
    el = torch.tensor([], dtype=cfg.dtype).element_size()
    d, n_l, h, hd = cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.d_head
    per_layer = 2 * d * h * hd + 2 * d * cfg.n_kv_heads * hd + 3 * d * cfg.d_ff
    head = 2 * cfg.vocab_padded * d * b
    cache = 2 * n_l * b * max_seq * cfg.n_kv_heads * hd * el
    pairs = s * (s + 1) // 2
    prefill = (2 * per_layer * n_l * b * s + 4 * hd * pairs * b * h * n_l
               + head,
               n_params * el + cache + 8 * b * s + 4 * b * cfg.vocab_padded)
    decode = (2 * per_layer * n_l * b + 4 * hd * max_seq * b * h * n_l + head,
              n_params * el + cache + 8 * b + 4 * b * cfg.vocab_padded)
    return prefill, decode


def bound(work, rate):
    ops, nbytes = work
    t_ops, t_bytes = ops / rate, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def lm_serve(tfm, model, cfg, prompts, max_seq, route=None, forced=None,
             counters=None):
    """``prefill`` then ``LM_STEPS`` decode steps, greedy or fed the
    tokens ``forced`` ``[b, LM_STEPS]``. Returns the last-position logits
    and every step's (real vocab, float32), the final caches, the tokens
    fed, the prefill's and each step's CUDA-event ms, and ``counters()``
    read just after the prefill."""
    v = cfg.vocab
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    last, caches = tfm.prefill(model, cfg, prompts, max_seq=max_seq,
                               route=route)
    ev[1].record()
    after_prefill = counters() if counters else None
    logits = [last[:, :v].float()]
    tok = logits[0].argmax(-1, keepdim=True)
    toks, steps = [], []
    for t in range(LM_STEPS):
        if forced is not None:
            tok = forced[:, t:t + 1]
        toks.append(tok)
        e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        e[0].record()
        out, caches = tfm.decode(model, cfg, caches, tok,
                                 prompts.shape[1] + t)
        e[1].record()
        steps.append(e)
        logits.append(out[:, 0, :v].float())
        tok = logits[-1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    return {"logits": logits, "caches": caches,
            "tokens": torch.cat(toks, dim=1),
            "prefill_ms": ev[0].elapsed_time(ev[1]),
            "step_ms": [a.elapsed_time(b) for a, b in steps],
            "after_prefill": after_prefill}


def rel_diff(a: torch.Tensor, b: torch.Tensor):
    """(max abs difference, that over the largest magnitude of ``b``)."""
    diff = float((a.double() - b.double()).abs().max())
    return diff, diff / max(float(b.double().abs().max()), 1e-30)


def compare_runs(k_run, s_run) -> dict:
    """Logit and cache differences of the kernel route's run against the
    scan route's, and each logits row's cosine similarity."""
    cos = [torch.nn.functional.cosine_similarity(
        a.double(), b.double(), dim=-1)
        for a, b in zip(k_run["logits"], s_run["logits"])]
    lg = [rel_diff(a, b) for a, b in zip(k_run["logits"], s_run["logits"])]
    cache = [rel_diff(getattr(kc, f), getattr(sc, f))
             for kc, sc in zip(k_run["caches"], s_run["caches"])
             for f in ("k", "v")]
    same_pos = all(torch.equal(kc.slot_pos, sc.slot_pos)
                   for kc, sc in zip(k_run["caches"], s_run["caches"]))
    return {"min_cosine": float(torch.stack(cos).min()),
            "logits_max_abs": max(d for d, _ in lg),
            "logits_max_rel": max(r for _, r in lg),
            "cache_max_abs": max(d for d, _ in cache),
            "cache_max_rel": max(r for _, r in cache),
            "slot_pos_equal": same_pos}


def _union_ms(intervals) -> float:
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def top_kernels(dev_events, per: int = 1, n: int = 8) -> dict:
    """The ``n`` device kernels (by name) that took the most time, in ms
    (over ``per`` repeats)."""
    by_name: dict = {}
    for e in dev_events:
        key = e.name[:60]
        by_name[key] = by_name.get(key, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3 / per
    return dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:n])


def lm_profile(tfm, model, cfg, prompts, max_seq, steps: int = 4) -> dict:
    """``torch.profiler`` over one prefill and ``steps`` decode steps: the
    device's busy ms in each, ``mha``'s kernel share of the prefill's
    busy time, and device kernels per decode step."""
    from torch.profiler import ProfilerActivity, profile

    def window(fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        dev = [e for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
        spans = [(e.time_range.start, e.time_range.end) for e in dev]
        return wall, dev, _union_ms(spans)

    out = {}
    holder = {}

    def pre():
        holder["logits"], holder["caches"] = tfm.prefill(
            model, cfg, prompts, max_seq=max_seq)

    wall, dev, busy = window(pre)
    mha_ms = _union_ms((e.time_range.start, e.time_range.end) for e in dev
                       if "flash_fwd" in e.name)
    out["prefill"] = {"wall_ms": wall, "device_busy_ms": busy,
                      "device_idle_share": 1 - busy / wall,
                      "mha_ms": mha_ms, "mha_share": mha_ms / busy,
                      "device_kernels": len(dev),
                      "top_kernels_ms": top_kernels(dev)}
    tok = holder["logits"][:, :cfg.vocab].argmax(-1, keepdim=True)

    def dec():
        nonlocal tok
        caches = holder["caches"]
        for t in range(steps):
            out_t, caches = tfm.decode(model, cfg, caches, tok,
                                       prompts.shape[1] + t)
            tok = out_t[:, 0, :cfg.vocab].argmax(-1, keepdim=True)

    wall, dev, busy = window(dec)
    out["decode"] = {"steps": steps, "wall_ms_per_step": wall / steps,
                     "device_busy_ms_per_step": busy / steps,
                     "device_idle_share": 1 - busy / wall,
                     "device_kernels_per_step": len(dev) / steps,
                     "top_kernels_ms_per_step": top_kernels(dev, steps)}
    return out


def phase_6b(dev, check) -> dict:
    """The LM serving path at full width: MiniCPM-2B in bfloat16 with
    seeded weights, prefill attention through ``mha`` (steps in the
    module docstring). Returns the report and the ``served`` entry of
    ``flash_attention``'s kernels line."""
    from repro_torch.kernels.flash_attention import flash_attention as fa_mod
    from repro_torch.kernels.flash_attention.ops import mha
    from repro_torch.models import transformer as tfm
    from repro_torch.nn import attention as attn
    from repro_torch.nn.module import count_params

    t_start = time.perf_counter()
    fa = fa_mod.flash_attention
    torch.cuda.reset_peak_memory_stats()

    def counters():
        return fa.launches, dict(attn.route_calls)

    def zero_counters():
        fa.launches = 0
        fa.route_launches.update(dict.fromkeys(fa.route_launches, 0))
        attn.route_calls.update(dict.fromkeys(attn.route_calls, 0))

    cfg = lm_config()
    n_l = cfg.n_layers
    model = tfm.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_params = count_params(model)
    b, s = LM_PROMPTS
    max_seq = s + LM_STEPS
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).to(dev)
    want = (n_l, {"kernel": n_l, "scan": 0})
    # 1. the kernel route (after one warm-up prefill of the same shape)
    tfm.prefill(model, cfg, prompts, max_seq=max_seq)
    torch.cuda.synchronize()
    zero_counters()
    k_run = lm_serve(tfm, model, cfg, prompts, max_seq, counters=counters)
    if k_run["after_prefill"] != want:
        fail(f"the MiniCPM-2B prefill made (mha launches, route calls) "
             f"{k_run['after_prefill']}, not {want}")
    if counters()[0] != n_l:
        fail("decode launched mha")
    if not all(torch.isfinite(x).all() for x in k_run["logits"]):
        fail("MiniCPM-2B logits are not finite")
    prefill_ms = time_ms(lambda: tfm.prefill(model, cfg, prompts,
                                             max_seq=max_seq),
                         reps=1, rounds=3)
    step_ms = float(np.median(k_run["step_ms"]))
    pre_w, dec_w = lm_work(cfg, n_params, b, s, max_seq)
    pre_bound, pre_by = bound(pre_w, BF16_OPS_PER_S)
    dec_bound, dec_by = bound(dec_w, BF16_OPS_PER_S)
    serve = {
        "arch": cfg.name, "params": n_params, "dtype": "bfloat16",
        "prompts": [b, s], "max_seq": max_seq, "decode_steps": LM_STEPS,
        "launches_in_prefill": k_run["after_prefill"][0],
        "route_calls_in_prefill": k_run["after_prefill"][1],
        "prefill_ms": prefill_ms,
        "prefill_first_ms": k_run["prefill_ms"],
        "prefill_tokens_per_s": b * s / (prefill_ms / 1e3),
        "prefill_bound_ms": pre_bound, "prefill_bound_by": pre_by,
        "prefill_tflop": pre_w[0] / 1e12,
        "decode_ms_per_step": step_ms,
        "decode_step_ms": k_run["step_ms"],
        "decode_tokens_per_s": b / (step_ms / 1e3),
        "decode_bound_ms": dec_bound, "decode_bound_by": dec_by,
        "decode_gb_per_step": dec_w[1] / 1e9,
        "cache_gb": sum(c.k.numel() + c.v.numel() for c in k_run["caches"])
        * 2 / 1e9,
    }
    print(f"phase 6b: {cfg.name} ({n_params} params, bf16) prefill "
          f"[{b}, {s}]: {prefill_ms:.2f} ms ({serve['prefill_tokens_per_s']:.0f}"
          f" tokens/s; bound {pre_bound:.2f} ms by {pre_by}), decode "
          f"{step_ms:.3f} ms a step ({serve['decode_tokens_per_s']:.0f} "
          f"tokens/s; bound {dec_bound:.3f} ms by {dec_by}); "
          f"{serve['launches_in_prefill']} mha launches, route calls "
          f"{serve['route_calls_in_prefill']}", flush=True)
    # 2. the same prompts on the forced scan route, fed the kernel route's
    # tokens
    zero_counters()
    s_run = lm_serve(tfm, model, cfg, prompts, max_seq, route="scan",
                     forced=k_run["tokens"], counters=counters)
    if s_run["after_prefill"] != (0, {"kernel": 0, "scan": n_l}):
        fail(f"the forced scan route made {s_run['after_prefill']}")
    bf16_cmp = compare_runs(k_run, s_run)
    if bf16_cmp["min_cosine"] < LM_COS or not bf16_cmp["slot_pos_equal"]:
        fail(f"bf16 kernel route against scan route: {bf16_cmp}")
    serve["bf16_vs_scan"] = bf16_cmp
    del k_run, s_run
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 6b: bf16 kernel route vs scan route, {LM_STEPS + 1} "
          f"logits rows a prompt: {json.dumps(bf16_cmp)}", flush=True)
    # 3. float32: the kernel route is mha's f32_fma kernel (TF32 off)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model32 = tfm.init(cfg32, torch.Generator(device=dev).manual_seed(0),
                       dev)
    p32 = prompts[:LM_F32_PROMPTS]
    zero_counters()
    k32 = lm_serve(tfm, model32, cfg32, p32, max_seq, counters=counters)
    if (k32["after_prefill"] != want
            or fa.route_launches["f32_fma"] != n_l):
        fail(f"the float32 prefill made {k32['after_prefill']}, routes "
             f"{fa.route_launches}")
    s32 = lm_serve(tfm, model32, cfg32, p32, max_seq, route="scan",
                   forced=k32["tokens"])
    f32_cmp = compare_runs(k32, s32)
    if (f32_cmp["logits_max_rel"] > LM_F32_TOL
            or f32_cmp["cache_max_rel"] > LM_F32_TOL
            or not f32_cmp["slot_pos_equal"]):
        fail(f"float32 kernel route against scan route: {f32_cmp}")
    serve["f32_vs_scan"] = f32_cmp
    del model32, k32, s32
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 6b: float32 kernel route (f32_fma) vs scan route, "
          f"[{LM_F32_PROMPTS}, {s}]: {json.dumps(f32_cmp)}", flush=True)
    # 4. prefill_32k's own length, one sequence
    long_p = torch.from_numpy(rng.integers(0, cfg.vocab, (1, LM_LONG))).to(
        dev)
    long_ms = []
    for rep in range(2):
        zero_counters()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        last, caches = tfm.prefill(model, cfg, long_p)
        ev[1].record()
        torch.cuda.synchronize()
        long_ms.append(ev[0].elapsed_time(ev[1]))
        if counters() != want or not torch.isfinite(
                last[:, :cfg.vocab]).all():
            fail(f"the 1 x {LM_LONG} prefill: counters {counters()}, "
                 "logits finite "
                 f"{bool(torch.isfinite(last[:, :cfg.vocab]).all())}")
        long_cache = sum(c.k.numel() + c.v.numel() for c in caches) * 2
        del last, caches
    long_w, _ = lm_work(cfg, n_params, 1, LM_LONG, LM_LONG)
    serve["long"] = {"prompts": [1, LM_LONG], "ms": long_ms[1],
                     "first_ms": long_ms[0],
                     "tokens_per_s": LM_LONG / (long_ms[1] / 1e3),
                     "bound_ms": bound(long_w, BF16_OPS_PER_S)[0],
                     "cache_gb": long_cache / 1e9, "launches": n_l}
    print(f"phase 6b: 1 x {LM_LONG} prefill {long_ms[1]:.1f} ms (first "
          f"{long_ms[0]:.1f}; bound {serve['long']['bound_ms']:.1f} ms), "
          f"cache {long_cache / 1e9:.2f} GB, {n_l} mha launches", flush=True)
    # 5. mha at the served shape, beside SDPA and its bound
    shape = (b, cfg.n_heads, s, cfg.d_head)
    gen = torch.Generator(device=dev).manual_seed(1)
    qkv = [torch.randn(shape, generator=gen, device=dev,
                       dtype=torch.bfloat16) for _ in range(3)]
    check("flash_attention", mha(*qkv, causal=True),
          mha(*qkv, causal=True, use_ref=True),
          f"MiniCPM served {shape} bf16 causal", ATTN_TOL[torch.bfloat16])
    pairs = s * (s + 1) // 2
    served = {
        "launches": n_l,
        "shape": list(shape),
        "ms": time_ms(lambda: mha(*qkv, causal=True), reps=5),
        "sdpa_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                *qkv, is_causal=True), reps=5),
        "bound_ms": bound((4 * cfg.d_head * pairs * b * cfg.n_heads,
                           4 * 2 * qkv[0].numel()), BF16_OPS_PER_S)[0],
    }
    del qkv
    # where the prefill's and the decode's time goes
    serve["profile"] = lm_profile(tfm, model, cfg, prompts, max_seq)
    serve["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # 6. release everything
    del model, prompts, long_p
    gc.collect()
    torch.cuda.empty_cache()
    serve["seconds"] = time.perf_counter() - t_start
    print(f"phase 6b: mha at {list(shape)}: {served['ms']:.4f} ms (SDPA "
          f"{served['sdpa_ms']:.4f} ms, bound {served['bound_ms']:.4f} ms); "
          f"profile {json.dumps(serve['profile'])}; peak device memory "
          f"{serve['peak_gb']:.3f} GB ({serve['seconds']:.1f} s)",
          flush=True)
    return {"serve": serve, "served": served}


# -- phase 8: LM training ----------------------------------------------------

TRAIN_LR = 3e-3  # launch/train.py's --lr default
TRAIN_SMOKE_BATCH = (2, 64)  # 8a: MiniCPM-smoke, card against the CPU
TRAIN_SMOKE_LR = 1e-3
TRAIN_BATCH = (2, 4096)  # 8b: train_4k's 256 x 4,096 cut to 2 x 4,096
TRAIN_STEPS = 4  # 8b: step 0 (lr scale 0), step 1, two warm steps
#: 8b: MiniCPM-2B's 40 layers cut to 10 at full width, so that the whole
#: run stays inside its time limit (PERF.md names the cut)
TRAIN_LAYERS = 10
RESUME_LAYERS = 1  # 8c: the full-width config cut to 1 layer
RESUME_BATCH = (2, 1024)
RESUME_STEPS = 4  # 8c: checkpoints at 2 and 4, a failure injected at 3
RESUME_SAVE_EVERY = 2
RESUME_FAIL_AT = 3
SCAN_LABEL = "scan_attention"  # 8b's profiled range around the scan
# 8a tolerances (float32, TF32 off): loss and gradient norm rtol; every
# parameter within 0.1 lr, and 1e-6 for all but 0.1% of them (the products
# add in other orders on the card; an AdamW step turns a rounding
# difference of a near-zero gradient into up to a tenth of lr)
TRAIN_RTOL = 1e-5
TRAIN_PARAM_ABS = 1e-6
TRAIN_PARAM_LOOSE = 1e-3


def _params_host(model) -> dict:
    return {k: p.detach().to("cpu", copy=True)
            for k, p in model.named_parameters()}


def _params_diff(model, host: dict):
    """(max abs difference, tensors that differ) of the model's parameters
    against a host copy, one tensor at a time."""
    worst, changed = 0.0, 0
    for k, p in model.named_parameters():
        p, ref = p.detach(), host[k].to(p.device)
        if not torch.equal(p, ref):
            changed += 1
            worst = max(worst, float((p.float() - ref.float()).abs().max()))
    return worst, changed


def train_bound(cfg, b: int, s: int):
    """(ms, formula, TFLOP) of a train step at the model-FLOP bound: 6 x
    active parameters x tokens, plus causal attention (QK^T and PV, 4 x
    d_head operations a (query, key) pair a head, three times: once
    forward, twice backward), at the bf16 tensor-core rate; the
    recompute is not model work."""
    n = cfg.active_params()
    pairs = s * (s + 1) // 2
    dense = 6 * n * b * s
    attn = 12 * cfg.d_head * pairs * b * cfg.n_heads * cfg.n_layers
    formula = (f"(6 * {n} active params * {b * s} tokens + 12 * d_head "
               f"{cfg.d_head} * {pairs} causal pairs * B {b} * H "
               f"{cfg.n_heads} * L {cfg.n_layers}) / {BF16_OPS_PER_S:.0f} "
               f"FLOP/s")
    return (dense + attn) / BF16_OPS_PER_S * 1e3, formula, (dense + attn) / 1e12


def _device_events(prof):
    """The device kernels of a profile (not the device-side spans of
    ``record_function`` ranges)."""
    return [e for e in prof.events()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)
            and e.name != SCAN_LABEL]


def _span_index(spans_by_thread: dict) -> dict:
    """Per thread, the union of (start, end) spans as sorted disjoint
    intervals. Events on one thread nest, so an event that starts inside
    the union ends inside the same interval."""
    out = {}
    for thread, spans in spans_by_thread.items():
        merged: list = []
        for a, b in sorted(spans):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        out[thread] = ([m[0] for m in merged], merged)
    return out


def _within(e, index: dict) -> bool:
    starts, merged = index.get(e.thread, ((), ()))
    i = bisect.bisect_right(starts, e.time_range.start) - 1
    return i >= 0 and e.time_range.end <= merged[i][1]


def scan_attention_ms(prof) -> float:
    """Device ms of the kernels launched by the scan attention: by the CPU
    ops inside the ``SCAN_LABEL`` ranges (its forward and its recompute)
    and by the backward functions whose sequence number is one of those
    ops'."""
    events = [e for e in prof.events()
              if not str(getattr(e, "device_type", "")).endswith("CUDA")]
    spans: dict = {}
    for e in events:
        if e.name == SCAN_LABEL:
            spans.setdefault(e.thread, []).append(
                (e.time_range.start, e.time_range.end))
    index = _span_index(spans)
    fwd = [e for e in events if e.name != SCAN_LABEL and _within(e, index)]
    seqs = {(e.thread, e.sequence_nr) for e in fwd if e.sequence_nr >= 0}
    bwd_spans: dict = {}
    for e in events:
        if (e.name.startswith("autograd::engine::evaluate_function")
                and (e.fwd_thread, e.sequence_nr) in seqs):
            bwd_spans.setdefault(e.thread, []).append(
                (e.time_range.start, e.time_range.end))
    index = _span_index(bwd_spans)
    bwd = [e for e in events if _within(e, index)]
    if not fwd or not bwd:
        fail(f"phase 8b: the profile holds {len(fwd)} scan-attention ops "
             f"and {len(bwd)} of their backward")
    seen = {id(e): e for e in fwd + bwd}
    return sum(k.duration for e in seen.values() for k in e.kernels) / 1e3


def phase_8a(dev, train) -> dict:
    """Two MiniCPM-smoke train steps on the card against the same steps on
    the CPU from the same weights (float32, TF32 off)."""
    from repro_torch.models import transformer as tfm
    from repro_torch.nn import attention as attn

    b, s = TRAIN_SMOKE_BATCH
    lr = TRAIN_SMOKE_LR
    runs = {}
    for where in ("cpu", dev):
        cfg, model, opt, _, stream, step = train.build(
            LM_ARCH, True, b, s, lr, where)
        if where != "cpu":
            with torch.no_grad():
                for k, p in model.named_parameters():
                    p.copy_(runs["cpu"]["init"][k])
        init = _params_host(model)
        batch = train.device_batch(stream.batch(0), where)
        calls = dict(attn.route_calls)
        out = []
        for _ in range(2):
            _, opt, loss, gnorm = step(model, opt, batch, 1.0)
            out.append((loss.item(), gnorm.item(), _params_host(model)))
        if attn.route_calls["kernel"] != calls["kernel"]:
            fail("phase 8a: a train step took the kernel route")
        runs[str(where)] = {"init": init, "steps": out}
    cpu, card = runs["cpu"]["steps"], runs[str(dev)]["steps"]
    rep = {"config": f"{cfg.name} float32, batch [{b}, {s}], lr {lr}",
           "loss_cpu": [x[0] for x in cpu], "loss_card": [x[0] for x in card],
           "gnorm_cpu": [x[1] for x in cpu],
           "gnorm_card": [x[1] for x in card]}
    worst, loose, n = 0.0, 0, 0
    for (l0, g0, p0), (l1, g1, p1) in zip(cpu, card):
        if not (np.isfinite(l1) and np.isfinite(g1)):
            fail(f"phase 8a: card loss {l1}, gradient norm {g1}")
        if (abs(l1 - l0) > TRAIN_RTOL * abs(l0)
                or abs(g1 - g0) > TRAIN_RTOL * abs(g0)):
            fail(f"phase 8a: card against CPU: {rep}")
        for k in p0:
            d = (p1[k] - p0[k]).abs()
            worst = max(worst, float(d.max()))
            loose += int((d > TRAIN_PARAM_ABS).sum())
            n += d.numel()
    rep.update(param_max_abs=worst, params_over_1e6=loose, params=n,
               tol={"loss_gnorm_rtol": TRAIN_RTOL,
                    "param_abs_all": 0.1 * lr,
                    "param_abs": TRAIN_PARAM_ABS,
                    "param_loose_share": TRAIN_PARAM_LOOSE})
    if worst > 0.1 * lr or loose > TRAIN_PARAM_LOOSE * n:
        fail(f"phase 8a: card parameters against the CPU's: {rep}")
    if not card[1][0] < card[0][0]:
        fail("phase 8a: the same batch twice did not descend")
    print("phase 8: 8a card vs cpu " + json.dumps(rep), flush=True)
    return rep


def phase_8b(dev, train) -> dict:
    """MiniCPM-2B at full width cut to ``TRAIN_LAYERS`` through
    ``train.build(smoke=False)``: four bf16 steps at ``TRAIN_BATCH``,
    then one warm step under the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels.flash_attention import flash_attention as fa_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.nn import attention as attn

    t_phase = time.perf_counter()
    fa = fa_mod.flash_attention
    torch.cuda.reset_peak_memory_stats()
    b, s = TRAIN_BATCH
    cfg, model, opt, sched, stream, step = train.build(
        LM_ARCH, False, b, s, TRAIN_LR, dev, n_layers=TRAIN_LAYERS)
    n_l = cfg.n_layers
    t_build = time.perf_counter() - t_phase
    opt_ms: list = []
    fwd_calls: list = []
    adamw, loss_fn = train.adamw_update, tfm.loss_fn

    def timed_adamw(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = adamw(*a, **kw)
        ev[1].record()
        opt_ms.append(ev)
        return out

    def counted_loss(*a, **kw):
        out = loss_fn(*a, **kw)
        fwd_calls.append(dict(attn.route_calls))
        return out

    train.adamw_update, tfm.loss_fn = timed_adamw, counted_loss
    try:
        steps = []
        host = _params_host(model)
        for i in range(TRAIN_STEPS + 1):
            batch = train.device_batch(stream.batch(i), dev)
            lr_scale = sched(i)
            attn.route_calls.update(dict.fromkeys(attn.route_calls, 0))
            fa.launches = 0
            torch.cuda.synchronize()
            if i < TRAIN_STEPS:
                t0 = time.perf_counter()
                _, opt, loss, gnorm = step(model, opt, batch, lr_scale)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            else:  # one more warm step, under the profiler
                scan = attn._attend_scan

                def ranged(*a, **kw):
                    with record_function(SCAN_LABEL):
                        return scan(*a, **kw)

                attn._attend_scan = ranged
                try:
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        t0 = time.perf_counter()
                        _, opt, loss, gnorm = step(model, opt, batch,
                                                   lr_scale)
                        torch.cuda.synchronize()
                        ms = (time.perf_counter() - t0) * 1e3
                finally:
                    attn._attend_scan = scan
            rec = {"step": i, "ms": ms, "loss": loss.item(),
                   "grad_norm": gnorm.item(), "lr_scale": float(lr_scale),
                   "optimizer_ms": opt_ms[-1][0].elapsed_time(opt_ms[-1][1]),
                   "route_calls_forward": fwd_calls[-1],
                   "route_calls_step": dict(attn.route_calls),
                   "mha_launches": fa.launches}
            if not (np.isfinite(rec["loss"]) and np.isfinite(
                    rec["grad_norm"])):
                fail(f"phase 8b: step {i} not finite: {rec}")
            if (rec["route_calls_forward"] != {"kernel": 0, "scan": n_l}
                    or rec["route_calls_step"] != {"kernel": 0,
                                                   "scan": 2 * n_l}
                    or fa.launches):
                fail(f"phase 8b: step {i} routes: {rec}")
            if i == 0:  # lr scale 0: the parameters must not move
                worst, changed = _params_diff(model, host)
                if rec["lr_scale"] != 0.0 or changed:
                    fail(f"phase 8b: step 0 moved {changed} parameters")
            if i == 1:
                worst, changed = _params_diff(model, host)
                rec.update(params_changed=changed, max_change=worst)
                if changed == 0:
                    fail("phase 8b: step 1 changed no parameter")
                del host
            steps.append(rec)
    finally:
        train.adamw_update, tfm.loss_fn = adamw, loss_fn
    peak = torch.cuda.max_memory_allocated() / 1e9
    bound_ms, formula, tflop = train_bound(cfg, b, s)
    warm = steps[2:TRAIN_STEPS]
    warm_ms = float(np.median([r["ms"] for r in warm]))
    dev_ev = _device_events(prof)
    busy = _union_ms((e.time_range.start, e.time_range.end) for e in dev_ev)
    t_parse = time.perf_counter()
    scan_ms = scan_attention_ms(prof)
    prof_step = steps[TRAIN_STEPS]
    rep = {
        "arch": cfg.name, "params": sum(p.numel()
                                        for p in model.parameters()),
        "dtype": "bfloat16 parameters, float32 AdamW moments",
        "batch": [b, s], "reduced": {"train_4k": "256 x 4096 -> "
                                     f"{b} x {s} sequences",
                                     "n_layers": f"40 -> {n_l}"},
        "remat": cfg.remat, "ce_chunk": cfg.ce_chunk,
        "build_s": t_build,
        "steps": steps[:TRAIN_STEPS],
        "warm_ms": warm_ms,
        "tokens_per_s": b * s / (warm_ms / 1e3),
        "optimizer_ms": float(np.median([r["optimizer_ms"] for r in warm])),
        "bound_ms": bound_ms, "bound_by": "operations",
        "bound_formula": formula, "tflop_per_step": tflop,
        "bound_share": bound_ms / warm_ms,
        "peak_gb": peak,
        "profile": {
            "step": prof_step["step"], "wall_ms": prof_step["ms"],
            "device_busy_ms": busy,
            "device_idle_share": 1 - busy / prof_step["ms"],
            "device_kernels": len(dev_ev),
            "top5_kernels_ms": top_kernels(dev_ev, n=5),
            "scan_attention_ms": scan_ms,
            "scan_attention_share": scan_ms / busy,
            "optimizer_ms": prof_step["optimizer_ms"],
            "parse_s": time.perf_counter() - t_parse,
        },
    }
    del model, opt, prof, dev_ev
    gc.collect()
    torch.cuda.empty_cache()
    rep["seconds"] = time.perf_counter() - t_phase
    print(f"phase 8: 8b {cfg.name} full width bf16 [{b}, {s}]: warm step "
          f"{warm_ms:.1f} ms ({rep['tokens_per_s']:.0f} tokens/s; bound "
          f"{bound_ms:.1f} ms = {formula}), optimizer "
          f"{rep['optimizer_ms']:.1f} ms, peak {peak:.2f} GB, device idle "
          f"{rep['profile']['device_idle_share']:.3f}, scan attention "
          f"{rep['profile']['scan_attention_share']:.3f} of busy",
          flush=True)
    print("phase 8: 8b " + json.dumps(rep), flush=True)
    return rep


def phase_8c(dev, train) -> dict:
    """Crash and resume at full width cut to ``RESUME_LAYERS`` layers: an
    uninterrupted run, then a ``TrainGuard`` run (checkpoints every
    ``RESUME_SAVE_EVERY`` steps) whose step ``RESUME_FAIL_AT`` fails once
    after the last checkpoint is on disk; the guard restores it in place.
    Both under ``torch.use_deterministic_algorithms(True)``: the restored
    state equals the saved one and the losses equal the uninterrupted
    run's, bitwise."""
    import shutil

    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs import base
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.optim.schedules import wsd_schedule
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.runtime.fault_tolerance import TrainGuard

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(base.get(LM_ARCH).full_config(),
                              n_layers=RESUME_LAYERS)
    ocfg = AdamWConfig(lr=TRAIN_LR)
    step_fn_of = train.make_train_step(cfg, ocfg)
    sched = wsd_schedule(warmup=20, total=10_000)
    b, s = RESUME_BATCH
    stream = TokenStream(vocab=cfg.vocab, seq_len=s, global_batch=b)
    ckdir = ROOT / "build" / "phase8_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)

    def fresh():
        model = tfm.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        model.requires_grad_(True)
        return model, adamw_init(dict(model.named_parameters()), ocfg)

    def one(model, live, i):
        batch = train.device_batch(stream.batch(i), dev)
        _, live["opt"], loss, gnorm = step_fn_of(model, live["opt"], batch,
                                                 sched(i))
        return loss.item(), gnorm.item()

    class Recorded(CheckpointManager):
        """Times each snapshot, write and restore; keeps the state the
        first snapshot was taken of."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.secs = {"snapshot": [], "write": [], "restore": []}
            self.saved = None

        def save(self, step, tree, blocking=False, shardings=None):
            if self.saved is None:
                self.saved = (step, tfm.state_to_numpy(model, live["opt"]))
            t0 = time.perf_counter()
            super().save(step, tree, blocking, shardings)
            self.secs["snapshot"].append(time.perf_counter() - t0)

        def _write(self, step, leaves):
            t0 = time.perf_counter()
            super()._write(step, leaves)
            self.secs["write"].append(time.perf_counter() - t0)

        def restore(self, like, step=None, shardings=None):
            t0 = time.perf_counter()
            out = super().restore(like, step, shardings)
            torch.cuda.synchronize()
            self.secs["restore"].append(time.perf_counter() - t0)
            return out

    torch.use_deterministic_algorithms(True)
    try:
        model, opt = fresh()
        live = {"opt": opt}
        plain = [one(model, live, i) for i in range(RESUME_STEPS)]
        del model, opt, live
        gc.collect()
        torch.cuda.empty_cache()
        model, opt = fresh()
        live = {"opt": opt}
        n_params = sum(p.numel() for p in model.parameters())
        ckpt = Recorded(str(ckdir), keep=3)
        guarded: list = []
        failed: list = []
        restored_eq: dict = {}

        def step_fn(state, i):
            if i == RESUME_FAIL_AT and not failed:
                ckpt.wait()  # the crash comes after the checkpoint is out
                failed.append(i)
                raise RuntimeError("injected failure")
            if failed and not restored_eq:  # the first step after restore
                step0, saved = ckpt.saved
                now = tfm.state_to_numpy(model, live["opt"])
                restored_eq.update(_states_equal(now, saved), step=step0)
            guarded.append((i, *one(model, live, i)))
            return tfm.state_tree(model, live["opt"])

        state, end = TrainGuard(ckpt=ckpt, save_every=RESUME_SAVE_EVERY).run(
            tfm.state_tree(model, live["opt"]), step_fn, RESUME_STEPS)
        ckpt.wait()
    finally:
        torch.use_deterministic_algorithms(False)
    nbytes = {d.name: sum(f.stat().st_size for f in d.iterdir())
              for d in ckdir.iterdir()}
    del model, opt, live, state, ckpt.saved
    shutil.rmtree(ckdir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    rep = {
        "config": f"{cfg.name} cut to {RESUME_LAYERS} layers (width kept), "
                  f"bf16, batch [{b}, {s}]",
        "params": n_params, "deterministic": True,
        "failure_at": failed, "end_step": end,
        "steps_run": [i for i, _, _ in guarded],
        "loss_plain": [l for l, _ in plain],
        "loss_guarded": [l for _, l, _ in guarded],
        "restored_equal": restored_eq,
        "checkpoint_bytes": nbytes,
        "snapshot_s": ckpt.secs["snapshot"], "write_s": ckpt.secs["write"],
        "restore_s": ckpt.secs["restore"],
        "seconds": time.perf_counter() - t_phase,
    }
    want_steps = [*range(RESUME_FAIL_AT), *range(RESUME_SAVE_EVERY,
                                                 RESUME_STEPS)]
    if (failed != [RESUME_FAIL_AT] or end != RESUME_STEPS
            or rep["steps_run"] != want_steps
            or not restored_eq.get("equal")
            or restored_eq.get("step") != RESUME_SAVE_EVERY):
        fail(f"phase 8c: {rep}")
    for i, l, g in guarded:
        if (l, g) != plain[i]:
            fail(f"phase 8c: step {i} gave loss {l}, gradient norm {g}; "
                 f"the uninterrupted run {plain[i]}")
    print("phase 8: 8c " + json.dumps(rep), flush=True)
    return rep


def _states_equal(now: dict, saved: dict) -> dict:
    """Bitwise comparison of two ``state_to_numpy`` trees."""
    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from flat(tree[k], f"{prefix}/{k}")
        elif isinstance(tree, tuple):
            for i, t in enumerate(tree):
                yield from flat(t, f"{prefix}[{i}]")
        else:
            yield prefix, tree

    a, b = dict(flat(now)), dict(flat(saved))
    differ = [k for k in b if k not in a or a[k].shape != b[k].shape
              or not np.array_equal(a[k], b[k])]
    return {"equal": sorted(a) == sorted(b) and not differ,
            "leaves": len(b), "differ": differ[:5]}


def phase_8(dev) -> dict:
    from repro_torch.launch import train

    t0 = time.perf_counter()
    out = {"8a": phase_8a(dev, train), "8b": phase_8b(dev, train),
           "8c": phase_8c(dev, train)}
    out["seconds"] = time.perf_counter() - t0
    return out


# -- phase 9: GNN training ----------------------------------------------------

GNN_ARCHS = ("schnet", "pna", "mace", "equiformer-v2")
GNN_WARM = 3  # timed warm steps after a cold one; then one under the profiler
GNN_FEAT_SEED = 2  # node-feature table of the sampled cell
# card against CPU (float32, TF32 off; ``index_add`` adds with atomics on
# the card): loss and forward outputs at rtol plus a share of the largest
# magnitude; the gradient norm at PNA's gradient bound's rtol and AdamW's
# moments at that bound leaf by leaf, rtol plus a share of the leaf's own
# largest moment (its std aggregator multiplies a rounding difference
# 500-fold where a node's messages have no variance); parameters within
# 1e-6 where the gradient clears that bound, else 2 lr (a first AdamW
# step moves a parameter by about lr * sign(g))
GNN_TOL = (1e-5, 1e-5)
GNN_GRAD_TOL = (1e-3, 1e-3)
GNN_PARAM_ABS = 1e-6
# 9a at full width, under torch.use_deterministic_algorithms (the card's
# sums add in edge order, bitwise the CPU's; only products and elementwise
# functions round otherwise). A sampled tree's leaves have in-degree 0, so
# PNA's attenuation scaler there is 3 / 1e-6 and activations reach
# 1e3-1e4: float32 rounding swamps the gradient of the first layers (the
# CPU's own float32 step is off its float64 step by a third of
# ``feat_proj``'s largest moment). So the step runs in float64 on both,
# card against CPU at GNN_F64_TOL per leaf (AdamW keeps its moments in
# float32); and the float32 steps are held against that float64 CPU step:
# per leaf, the card's error within GNN_EXACT_RATIO times the CPU's plus
# GNN_EXACT_FLOOR of the leaf's largest moment (as accurate as the CPU)
GNN_F64_TOL = (1e-6, 1e-6)
GNN_EXACT_RATIO = 4.0
GNN_EXACT_FLOOR = 1e-5
GNN_ROT_TOL = (2e-3, 2e-3)  # JAX's own rotation bound (test_gnn_smoke.py)


def _gnn_close(got, exp, tol):
    """(ok, worst abs difference): |got - exp| <= rtol |exp| + share
    max|exp| everywhere."""
    g = torch.as_tensor(got).detach().double().cpu()
    e = torch.as_tensor(exp).detach().double().cpu()
    diff = (g - e).abs()
    lim = tol[0] * e.abs() + tol[1] * float(e.abs().max())
    return bool((diff <= lim).all()), float(diff.max())


def _gnn_step_check(what, cpu, card, lr, tol=GNN_GRAD_TOL, leaves=5,
                    where="cpu"):
    """Card step against CPU step, each ``(loss, gnorm, params, mu, nu)``:
    the loss at ``GNN_TOL``, the gradient norm at ``tol``'s rtol, each
    leaf's AdamW moments at ``tol`` (rtol plus a share of that leaf's own
    largest moment), the parameters within ``GNN_PARAM_ABS`` where the
    gradient clears its bound and within 2 lr elsewhere. Reports each
    leaf's worst difference as a share of its own largest moment (the
    ``leaves`` worst leaves; every leaf when None). The comparisons run
    on ``where`` (the card for a full-width model: its float64 passes
    over 577M parameters take the CPU seconds). Fails with every number
    gathered."""
    out, bad = {}, []
    for i, name, t in ((0, "loss", GNN_TOL), (1, "grad_norm", tol)):
        ok, _ = _gnn_close(card[i], cpu[i], (t[0], 0.0))
        out[name] = {"cpu": float(cpu[i]), "card": float(card[i])}
        if not ok or not np.isfinite(float(card[i])):
            bad.append(name)
    shares = {}
    worst_p = 0.0
    noise = n = 0
    for k, p in cpu[2].items():
        shares[k] = []
        for j, m in enumerate((3, 4)):
            e = cpu[m][k].to(where).double()
            d = (card[m][k].to(where).double() - e).abs()
            scale = float(e.abs().max())
            shares[k].append(float(d.max()) / max(scale, 1e-30))
            if (d > tol[0] * e.abs() + tol[1] * scale).any():
                bad.append(f"moment {j} of {k} ({shares[k][-1]:.3g} of its "
                           "largest)")
        # a first AdamW step moves p by about lr * sign(g): where the
        # (clipped) gradient, read from the CPU's first moment, is within
        # twice its bound of 0 its sign is rounding, and the two steps may
        # part by up to 2 lr; elsewhere they agree within GNN_PARAM_ABS
        g = cpu[3][k].to(where).double().abs()
        signal = g > 2 * (tol[0] * g + tol[1] * float(g.max()))
        d = (card[2][k].to(where) - p.to(where)).abs()
        worst_p = max(worst_p, float(d[signal].max()) if signal.any() else 0)
        noise += int((~signal).sum())
        n += d.numel()
        if (d[signal] > GNN_PARAM_ABS).any() or (d > 2 * lr + 1e-6).any():
            bad.append(f"parameter {k} ({float(d.max()):.3g})")
    ranked = sorted(shares.items(), key=lambda kv: -max(kv[1]))
    out.update(param_max_abs=worst_p,
               moment_max_share=[max(v[j] for v in shares.values())
                                 for j in (0, 1)],
               leaf_moment_share=dict(ranked[:leaves] if leaves else ranked),
               params_in_gradient_noise=noise, params=n, tol=tol)
    if bad:
        fail(f"phase {what}: {bad[:8]}: {json.dumps(out)}")
    return out


def _gnn_exact_check(what, cpu, card, exact, lr):
    """Float32 steps on the CPU and the card, each ``(loss, gnorm, params,
    mu, nu)``, against the float64 CPU step from the same weights
    (``exact``): the loss and gradient norm, and each leaf's moments as
    the worst error over the leaf's largest exact moment, the card's
    within ``GNN_EXACT_RATIO`` times the CPU's plus ``GNN_EXACT_FLOOR``
    (the card's distance from the CPU on the same scale reported);
    parameters within ``GNN_PARAM_ABS`` of the exact step where the exact
    gradient clears twice the card's bound, within 2 lr elsewhere. Fails
    with every number gathered."""
    out, bad = {}, []
    for i, name in ((0, "loss"), (1, "grad_norm")):
        e = float(exact[i])
        err = [abs(float(x[i]) - e) / abs(e) for x in (cpu, card)]
        out[name] = {"exact": e, "cpu": float(cpu[i]), "card": float(card[i])}
        if not (np.isfinite(err[1])
                and err[1] <= GNN_EXACT_RATIO * err[0] + GNN_TOL[0]):
            bad.append(name)
    shares = {}
    worst_p = 0.0
    noise = n = 0
    for k, p in exact[2].items():
        shares[k] = []
        for j, m in enumerate((3, 4)):
            e = exact[m][k].double()
            scale = max(float(e.abs().max()), 1e-30)
            c, g = (float((x[m][k].cpu().double() - e).abs().max()) / scale
                    for x in (cpu, card))
            apart = (card[m][k].cpu().double() - cpu[m][k].double()).abs()
            shares[k].append({"cpu": c, "card": g,
                              "card_vs_cpu": float(apart.max()) / scale})
            if not g <= GNN_EXACT_RATIO * c + GNN_EXACT_FLOOR:
                bad.append(f"moment {j} of {k} (card {g:.3g}, cpu {c:.3g} "
                           "of its largest)")
        # where the exact first moment clears twice the bound the card's
        # is held to, the card's has its sign, and a first AdamW step
        # moves p by about lr * sign(g)
        e = exact[3][k].double().abs()
        bound = (GNN_EXACT_RATIO * shares[k][0]["cpu"]
                 + GNN_EXACT_FLOOR) * float(e.max())
        signal = e > 2 * bound
        d = (card[2][k].cpu().double() - p.double()).abs()
        worst_p = max(worst_p, float(d[signal].max()) if signal.any() else 0)
        noise += int((~signal).sum())
        n += d.numel()
        if (d[signal] > GNN_PARAM_ABS).any() or (d > 2 * lr + 1e-6).any():
            bad.append(f"parameter {k} ({float(d.max()):.3g})")
    out.update(param_max_abs=worst_p, leaf_moment_share_vs_float64=shares,
               params_in_gradient_noise=noise, params=n,
               ratio=GNN_EXACT_RATIO, floor=GNN_EXACT_FLOOR)
    if bad:
        fail(f"phase 9: {what}: {bad[:8]}: {json.dumps(out)}")
    return out


def _gnn_snapshot(model, opt, loss, gnorm):
    def host(d):
        return {k: v.detach().to("cpu", copy=True) for k, v in d.items()}

    return (loss.item(), gnorm.item(), host(dict(model.named_parameters())),
            host(opt.mu), host(opt.nu))


def _gnn_pair(steps, cell, batch, dev, seed, dtype=torch.float32):
    """One train step from the same seeded float32 weights, held in
    ``dtype``, on the CPU and on the card: (cpu snapshot, card snapshot,
    the card's (model, opt, step))."""
    from repro_torch.models.gnn import common as gcom
    from repro_torch.optim.adamw import adamw_init

    mod = steps.GNN_MODULES[cell.arch_id]
    cpu_model = steps.init_model(cell, torch.Generator().manual_seed(seed),
                                 "cpu")
    card_model = mod.params_from_jax(
        cell.cfg, gcom.params_to_numpy(cpu_model), dev).requires_grad_(True)
    cpu_model, card_model = cpu_model.to(dtype), card_model.to(dtype)
    step = steps.make_train_step(cell)
    snaps = []
    for model, where in ((cpu_model, "cpu"), (card_model, dev)):
        opt = adamw_init(steps.params_dict(model), steps.GNN_ADAMW)
        b = {k: v.to(where) for k, v in batch.items()}
        _, opt, loss, gnorm = step(model, opt, b)
        snaps.append(_gnn_snapshot(model, opt, loss, gnorm))
    return snaps[0], snaps[1], (card_model, opt, step)


def gnn_profile(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: wall ms, device busy ms
    (the union of kernel spans), idle share, kernels, the five largest."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = _device_events(prof)
    busy = _union_ms((e.time_range.start, e.time_range.end) for e in ev)
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall, "device_kernels": len(ev),
            "top5_kernels_ms": top_kernels(ev, n=5)}


def gnn_train_timed(step, model, opt, batches, label) -> dict:
    """A cold step, ``GNN_WARM`` timed warm steps and one profiled step;
    ``batches(i)`` gives step i's batch on the card (its time apart)."""
    torch.cuda.reset_peak_memory_stats()
    recs = []
    for i in range(GNN_WARM + 2):
        batch, prep_ms = batches(i)
        holder = {}

        def run():
            holder["out"] = step(model, opt, batch)

        if i <= GNN_WARM:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            rec = {"step": i, "ms": (time.perf_counter() - t0) * 1e3}
        else:
            prof = gnn_profile(run)
            rec = {"step": i, "ms": prof["wall_ms"]}
        _, opt, loss, gnorm = holder["out"]
        rec.update(loss=loss.item(), grad_norm=gnorm.item(),
                   prep_ms=prep_ms)
        if not (np.isfinite(rec["loss"]) and np.isfinite(rec["grad_norm"])):
            fail(f"phase {label} step {i} not finite: {rec}")
        recs.append(rec)
    warm_ms = float(np.median([r["ms"] for r in recs[1:GNN_WARM + 1]]))
    # the profiler slows the host, so its step idles more than a warm one:
    # the warm step's idle share, from the profiled step's device time (a
    # negative share says the two steps' device times disagree)
    prof["warm_idle_share"] = 1 - prof["device_busy_ms"] / warm_ms
    if prof["warm_idle_share"] < 0:
        print(f"phase {label}: the profiled step's device time "
              f"{prof['device_busy_ms']:.3f} ms exceeds the warm step's "
              f"{warm_ms:.3f} ms: its warm idle share is no share",
              flush=True)
    return {"steps": recs, "cold_ms": recs[0]["ms"], "warm_ms": warm_ms,
            "profile": prof,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def pna_bytes(cell, n: int, e: int) -> float:
    """Bytes the PNA train step's gathers and scatters move at least,
    float32, three times a forward's (forward, recompute, backward): per
    layer two gathers of ``E x d`` read and written, four segment
    reductions of ``E x d`` into ``N x d`` (sum, sum of squares, max,
    min) and one count of ``E`` into ``N``."""
    d = cell.cfg.d_hidden
    per = 2 * 2 * e * d + 4 * (e * d + n * d) + (e + n)
    return 3.0 * 4 * cell.cfg.n_layers * per


def phase_9a(dev, csr, steps) -> dict:
    """Sampled PNA at full width: ``minibatch_lg``'s 1,024 seeds a batch
    (``GraphSeedStream``), fanouts (15, 10), sampled on the card from the
    scale-10 LDBC proxy's forward ELL."""
    from repro_torch.data.pipeline import GraphSeedStream
    from repro_torch.graph import sampler
    from repro_torch.graph.csr import ell_from_csr
    from repro_torch.kernels.common import to_device
    from repro_torch.models.gnn import common as gcom

    t_phase = time.perf_counter()
    cell = steps.gnn_cell("pna", "minibatch_lg")
    t0 = time.perf_counter()
    ell_cpu = ell_from_csr(csr)
    ell = to_device(ell_cpu, dev)
    ell_s = time.perf_counter() - t0
    feats = torch.randn((csr.n_nodes, cell.cfg.d_feat),
                        generator=torch.Generator().manual_seed(GNN_FEAT_SEED))
    feats_dev = feats.to(dev)
    eye = torch.eye(cell.cfg.n_out)
    stream = GraphSeedStream(n_nodes=csr.n_nodes, batch_nodes=cell.seeds,
                             n_classes=cell.cfg.n_out)
    sgen = torch.Generator(device=dev).manual_seed(1)
    fanout = cell.fanout

    def sampled(i):
        sb = stream.batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sub = sampler.sample_subgraph(ell, sb["seeds"], fanout, sgen,
                                      device=dev)
        batch = {"edge_src": sub.edge_src, "edge_dst": sub.edge_dst,
                 "node_feat": feats_dev[sub.nodes.long()],
                 "targets": eye[torch.from_numpy(sb["labels"]).long()].to(
                     dev)}
        torch.cuda.synchronize()
        return sub, batch, (time.perf_counter() - t0) * 1e3

    # the sampler on the card against the CPU's on the same raw slots
    sb = stream.batch(0)
    raws = []
    n_front = cell.seeds
    for f in fanout:
        raws.append(sampler.draw_slots(sgen, n_front, f))
        n_front *= f
    sub_card = sampler.sample_subgraph(ell, sb["seeds"], fanout,
                                       raw_slots=raws, device=dev)
    sub_cpu = sampler.sample_subgraph(ell_cpu, sb["seeds"], fanout,
                                      raw_slots=[r.cpu() for r in raws],
                                      device="cpu")
    for name in ("nodes", "edge_src", "edge_dst"):
        if not torch.equal(getattr(sub_card, name).cpu(),
                           getattr(sub_cpu, name)):
            fail(f"phase 9a: sampled {name} on the card differ from the "
                 f"CPU's")
    del ell_cpu, sub_cpu
    gc.collect()
    # the first train step on the card against the CPU on that batch
    sub, batch, _ = sampled(0)
    if (sub.nodes.shape[0], sub.edge_src.shape[0]) != (cell.n_nodes,
                                                       cell.n_edges):
        fail(f"phase 9a: sampled {sub.nodes.shape[0]} nodes, "
             f"{sub.edge_src.shape[0]} edges, not the cell's")
    t0 = time.perf_counter()
    # deterministic sums on the card: what differs from the CPU is only
    # the products' and elementwise functions' rounding
    torch.use_deterministic_algorithms(True)
    try:
        cpu, card, (model, opt, step) = _gnn_pair(steps, cell, batch, dev, 0)
        cpu64, card64, _ = _gnn_pair(steps, cell, batch, dev, 0,
                                     torch.float64)
    finally:
        torch.use_deterministic_algorithms(False)
    pair_s = time.perf_counter() - t0
    lr = steps.GNN_ADAMW.lr
    check = {
        "float64": _gnn_step_check("9a float64 card vs cpu", cpu64, card64,
                                   lr, GNN_F64_TOL, leaves=None),
        "float32": _gnn_exact_check("9a float32 against the float64 cpu "
                                    "step", cpu, card, cpu64, lr)}
    del cpu, card, cpu64, card64
    # deterministic sums: the card's index_add in edge order
    msg = torch.randn((cell.n_edges, cell.cfg.d_hidden),
                      generator=torch.Generator().manual_seed(3))
    torch.use_deterministic_algorithms(True)
    try:
        det = gcom.aggregate(msg.to(dev), batch["edge_dst"].long(),
                             cell.n_nodes, "sum").cpu()
    finally:
        torch.use_deterministic_algorithms(False)
    atomic = gcom.aggregate(msg.to(dev), batch["edge_dst"].long(),
                            cell.n_nodes, "sum").cpu()
    host = gcom.aggregate(msg, batch["edge_dst"].long().cpu(), cell.n_nodes,
                          "sum")
    sums = {"deterministic_bitwise_cpu": bool(torch.equal(det, host)),
            "atomic_max_abs_vs_cpu": max_abs_err(atomic, host)}
    del msg, det, atomic, host

    def batches(i):
        _, b, ms = sampled(i + 1)
        return b, ms

    run = gnn_train_timed(step, model, opt, batches, "9a")
    flops = cell.flops
    ops_ms = flops / F32_OPS_PER_S * 1e3
    nbytes = pna_bytes(cell, cell.n_nodes, cell.n_edges)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    sample_ms = float(np.median([r["prep_ms"] for r in run["steps"][1:]]))
    rep = {
        "arch": "pna", "cell": "minibatch_lg",
        "config": dataclasses.asdict(cell.cfg),
        "batch": {"seeds": cell.seeds, "fanout": list(fanout),
                  "nodes": cell.n_nodes, "edges": cell.n_edges},
        "reduced": {"graph": "Reddit (232,965 nodes, 114,615,892 edges) -> "
                             f"LDBC proxy scale {SCALE:g} ({csr.n_nodes} "
                             f"nodes, {csr.n_edges} edges), sampled from its "
                             "forward ELL; nothing downloaded"},
        "ell_build_s": ell_s, "cpu_pair_s": pair_s,
        "card_vs_cpu": check, "card_vs_cpu_deterministic": True,
        "tol": {"loss": GNN_TOL, "float64_per_leaf": GNN_F64_TOL,
                "float32_vs_float64": [GNN_EXACT_RATIO, GNN_EXACT_FLOOR],
                "param_abs": GNN_PARAM_ABS},
        "sums": sums,
        **run,
        "sample_ms": sample_ms,
        "seeds_per_s": cell.seeds / (run["warm_ms"] / 1e3),
        "seeds_per_s_with_sampling": cell.seeds / (
            (run["warm_ms"] + sample_ms) / 1e3),
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "ops_bound_ms": ops_ms, "bytes_bound_ms": bytes_ms,
        "bound_formula": f"max(3 x gnn_flops {flops / 3:.4g} / "
                         f"{F32_OPS_PER_S:.3g} FLOP/s, gathers and scatters "
                         f"{nbytes:.4g} B / {HBM_BYTES_PER_S:.3g} B/s)",
    }
    rep["bound_share"] = rep["bound_ms"] / run["warm_ms"]
    del model, opt, ell, feats_dev
    gc.collect()
    torch.cuda.empty_cache()
    rep["seconds"] = time.perf_counter() - t_phase
    print(f"phase 9: 9a sampled PNA [{cell.seeds} seeds, {fanout}]: warm "
          f"step {run['warm_ms']:.2f} ms + sampling {sample_ms:.2f} ms, "
          f"{rep['seeds_per_s']:.0f} seeds/s (bound {rep['bound_ms']:.2f} ms "
          f"by {rep['bound_by']}), peak {run['peak_gb']:.3f} GB, device "
          f"idle {run['profile']['warm_idle_share']:.3f} (profiled step "
          f"{run['profile']['device_idle_share']:.3f})", flush=True)
    print("phase 9: 9a " + json.dumps(rep), flush=True)
    return rep


def _rotated(batch, seed=5):
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    out = dict(batch)
    rot = torch.from_numpy(q.T.astype(np.float32)).to(
        batch["positions"].device)
    out["positions"] = batch["positions"] @ rot
    return out


def phase_9b(dev, steps) -> dict:
    """Each arch at its full config on ``molecule`` (128 graphs of 30 nodes
    and 64 edges, ``graph_out`` readout), and PNA on ``full_graph_sm``; for
    the geometric archs ``graph_out`` under a random rotation."""
    out = {}
    cases = [(a, "molecule") for a in GNN_ARCHS] + [("pna", "full_graph_sm")]
    for arch, shape in cases:
        t0 = time.perf_counter()
        cell = steps.gnn_cell(arch, shape)
        _, model, opt, step = steps.build(
            arch, shape, torch.Generator(device=dev).manual_seed(0), dev)
        batches_np = [steps.cell_batch(cell, seed=i)
                      for i in range(GNN_WARM + 2)]

        def batches(i):
            t = time.perf_counter()
            b = steps.batch_to(batches_np[i], dev)
            torch.cuda.synchronize()
            return b, (time.perf_counter() - t) * 1e3

        run = gnn_train_timed(step, model, opt, batches, f"9b {arch}")
        ops_ms = cell.flops / F32_OPS_PER_S * 1e3
        rep = {"arch": arch, "cell": shape, "nodes": cell.n_nodes,
               "edges": cell.n_edges,
               "params": sum(p.numel() for p in model.parameters()),
               **{k: v for k, v in run.items() if k != "steps"},
               "losses": [r["loss"] for r in run["steps"]],
               "bound_ms": ops_ms, "bound_by": "operations",
               "bound_formula": f"3 x gnn_flops {cell.flops / 3:.4g} / "
                                f"{F32_OPS_PER_S:.3g} FLOP/s",
               "bound_share": ops_ms / run["warm_ms"]}
        if cell.geometric:
            b = steps.batch_to(batches_np[0], dev)
            b["n_graphs"] = cell.n_graphs
            mod = steps.GNN_MODULES[arch]
            with torch.no_grad():
                g1 = mod.apply(model, cell.cfg, b)["graph_out"]
                g2 = mod.apply(model, cell.cfg, _rotated(b))["graph_out"]
            ok, worst = _gnn_close(g2, g1, GNN_ROT_TOL)
            rep["rotation"] = {"max_abs": worst, "tol": GNN_ROT_TOL,
                               "graph_out_max": float(g1.abs().max())}
            if not ok or not bool(torch.isfinite(g1).all()):
                fail(f"phase 9b: {arch} graph_out not rotation invariant: "
                     f"{rep['rotation']}")
        del model, opt, step
        gc.collect()
        torch.cuda.empty_cache()
        rep["seconds"] = time.perf_counter() - t0
        print(f"phase 9: 9b {arch} {shape}: warm step {run['warm_ms']:.2f} "
              f"ms (bound {ops_ms:.4f} ms), peak {run['peak_gb']:.3f} GB, "
              f"device idle {run['profile']['warm_idle_share']:.3f} "
              f"(profiled step {run['profile']['device_idle_share']:.3f})"
              + (f", rotation max abs {rep['rotation']['max_abs']:.3g}"
                 if "rotation" in rep else ""), flush=True)
        print("phase 9: 9b " + json.dumps(rep), flush=True)
        out[f"{arch}/{shape}"] = rep
    return out


def phase_9c(dev, steps) -> dict:
    """Smoke configs in float32, card against CPU from the same weights:
    the forward's outputs and one train step, every arch."""
    from repro_torch.models.gnn import common as gcom

    out = {}
    for arch in GNN_ARCHS:
        cell = steps.gnn_cell(arch, "molecule", smoke=True)
        batch = steps.batch_to(steps.cell_batch(cell, seed=7), "cpu")
        mod = steps.GNN_MODULES[arch]
        cpu_model = steps.init_model(cell, torch.Generator().manual_seed(1),
                                     "cpu")
        card_model = mod.params_from_jax(cell.cfg,
                                         gcom.params_to_numpy(cpu_model), dev)
        fwd = {}
        with torch.no_grad():
            b = dict(batch, n_graphs=cell.n_graphs)
            o_cpu = mod.apply(cpu_model, cell.cfg, b)
            o_card = mod.apply(card_model, cell.cfg,
                               {k: (v.to(dev) if torch.is_tensor(v) else v)
                                for k, v in b.items()})
        for key in ("node_out", "graph_out"):
            ok, worst = _gnn_close(o_card[key], o_cpu[key], GNN_TOL)
            fwd[key] = worst
            if not ok:
                fail(f"phase 9c: {arch} {key} card vs CPU off by {worst}")
        cpu, card, _ = _gnn_pair(steps, cell, batch, dev, 1)
        rep = {"forward_max_abs": fwd,
               "step": _gnn_step_check(f"9c {arch}", cpu, card,
                                       steps.GNN_ADAMW.lr)}
        print(f"phase 9: 9c {arch} smoke card vs cpu " + json.dumps(rep),
              flush=True)
        out[arch] = rep
    return out


def phase_9(dev, csr, launches_before) -> dict:
    """GNN training (no kernel: JAX's GNNs aggregate with XLA scatters, the
    port with ``index_add``/``scatter_reduce``)."""
    from repro_torch.launch import steps

    t0 = time.perf_counter()
    out = {"9c": phase_9c(dev, steps), "9a": phase_9a(dev, csr, steps),
           "9b": phase_9b(dev, steps)}
    out["kernel_launches"] = launches_before()
    if any(out["kernel_launches"].values()):
        fail(f"phase 9 launched a port kernel: {out['kernel_launches']}")
    out["seconds"] = time.perf_counter() - t0
    return out


RECSYS_ARCH = "dcn-v2"
RECSYS_SMOKE_B = 512  # 10c: the smoke config's batch, card against CPU
RECSYS_CHECK_B = 512  # 10a: the full-width forward, card against CPU
RECSYS_CHECK_TRAIN_B = 2048  # 10a: one full-width train step, card vs CPU
RECSYS_SERVE_CALLS = 60  # serve_p99: warm calls, host batch to host logits
RECSYS_BULK_CALLS = 3  # serve_bulk: warm calls
RECSYS_RETRIEVAL_CALLS = 20
# card against CPU (float32, TF32 off): logits and the loss at rtol plus a
# share of the largest magnitude; the gradient norm at GNN_GRAD_TOL's rtol,
# AdamW's moments leaf by leaf at GNN_GRAD_TOL (rtol plus a share of the
# leaf's largest moment); embedding bags within RECSYS_BAG_TOL
RECSYS_TOL = (1e-5, 1e-5)
RECSYS_BAG_TOL = 1e-6
# 10a's full-width step runs in float64 on the card and the CPU, held at
# 1e-6 per leaf: at B 2,048 the float32 forwards of the card and the CPU
# put a few of the 5.2M MLP pre-activations on opposite sides of 0 (their
# products add in other orders), and each such ReLU kink sends one
# example's whole gradient another way: up to 3% of the table's largest
# first moment (measured on an H100). In float64 the two sides agree to
# about 1e-16, so a kink between them is some 1e-9 as likely; AdamW keeps
# its moments in float32
RECSYS_F64_TOL = (1e-6, 1e-6)
PIPE_MICRO = (8, 512, 2304)  # 10d: M microbatches of [512, 2304], S = RANKS
PIPE_TOL = 1e-6
PHASE10_TIMEOUT_S = 300


def _distinct_equal(idx, ref_vals, ref_idx, gap=1e-5) -> bool:
    """Top-k indices equal to the reference's wherever a reference score
    stands more than ``gap`` from its neighbours (ties may swap)."""
    d = torch.diff(ref_vals.double().cpu(), dim=1).abs()
    inf = torch.full_like(d[:, :1], np.inf)
    distinct = torch.minimum(torch.cat([inf, d], dim=1),
                             torch.cat([d, inf], dim=1)) > gap
    return bool(torch.equal(idx.cpu()[distinct], ref_idx.cpu()[distinct]))


def _live_snapshot(model, opt, loss, gnorm):
    """``_gnn_snapshot`` without copies (the model and state are not
    used again): the card's leaves stay on the card until the check."""
    return (loss.item(), gnorm.item(),
            {k: p.detach() for k, p in model.named_parameters()},
            opt.mu, opt.nu)


def _recsys_step_pair(steps, cell, cpu_model, card_model, card_off, batch,
                      dev, snapshot=_gnn_snapshot):
    """One train step from the same weights on the CPU and on the card
    (``recsys_step``, AdamW from zero moments): the two snapshots
    ``(loss, gnorm, params, mu, nu)``."""
    from repro_torch.models import dcn_v2 as dcn
    from repro_torch.optim.adamw import adamw_init

    snaps = []
    for model, off, where in ((cpu_model, dcn.field_offsets(cell.cfg, "cpu"),
                               "cpu"), (card_model, card_off, dev)):
        model.requires_grad_(True)
        opt = adamw_init(steps.params_dict(model), steps.RECSYS_ADAMW)
        _, opt, loss, gnorm = steps.recsys_step(cell, off)(
            model, opt, steps.batch_to(batch, where))
        snaps.append(snapshot(model, opt, loss, gnorm))
        del opt
    return snaps


def phase_10c(dev, steps) -> dict:
    """The smoke config, card against CPU from the same weights, under
    ``torch.use_deterministic_algorithms``: logits, one train step,
    ``embedding_bag`` sum and mean, retrieval top-k."""
    from repro_torch.models import dcn_v2 as dcn
    from repro_torch.models.gnn.common import params_to_numpy
    from repro_torch.nn.embedding_bag import embedding_bag

    torch.use_deterministic_algorithms(True)
    try:
        cell = steps.recsys_cell(RECSYS_ARCH, "train_batch", smoke=True,
                                 dims=dict(batch=RECSYS_SMOKE_B))
        cpu_model, cpu_off = dcn.init(cell.cfg,
                                      torch.Generator().manual_seed(1), "cpu")
        card_model, card_off = dcn.params_from_jax(
            params_to_numpy(cpu_model), cell.cfg, dev)
        batch = steps.recsys_batch(cell, seed=7)
        with torch.no_grad():
            exp = dcn.forward(cpu_model, cell.cfg,
                              steps.batch_to(batch, "cpu"), cpu_off)
            got = dcn.forward(card_model, cell.cfg,
                              steps.batch_to(batch, dev), card_off)
        ok, logit_err = _gnn_close(got, exp, RECSYS_TOL)
        if not ok:
            fail(f"phase 10c: smoke logits card vs CPU off by {logit_err}")
        cpu, card = _recsys_step_pair(steps, cell, cpu_model, card_model,
                                      card_off, batch, dev)
        step = _gnn_step_check("10c dcn-v2 smoke", cpu, card,
                               steps.RECSYS_ADAMW.lr)
        rng = np.random.default_rng(8)
        nnz, n_bags = 20000, 1000
        fids = torch.from_numpy(rng.integers(0, cell.cfg.n_sparse, nnz)
                                .astype(np.int32))
        ids = torch.from_numpy(rng.integers(0, 97, nnz).astype(np.int32))
        bags = torch.from_numpy(np.sort(rng.integers(0, n_bags, nnz))
                                .astype(np.int32))
        bag_err = {}
        with torch.no_grad():
            for mode in ("sum", "mean"):
                e = embedding_bag(cpu_model.embed, cpu_off, ids, fids, bags,
                                  n_bags, mode)
                g = embedding_bag(card_model.embed, card_off, ids.to(dev),
                                  fids.to(dev), bags.to(dev), n_bags, mode)
                bag_err[mode] = float((g.cpu() - e).abs().max())
                if not bag_err[mode] <= RECSYS_BAG_TOL:
                    fail(f"phase 10c: embedding_bag {mode} card vs CPU off "
                         f"by {bag_err[mode]}")
        rcell = steps.recsys_cell(RECSYS_ARCH, "retrieval_cand", smoke=True,
                                  dims=dict(batch=4, n_candidates=100_000))
        cand = steps.retrieval_candidates(rcell,
                                          torch.Generator().manual_seed(9))
        rb = steps.recsys_batch(rcell, seed=9)
        v0, i0 = steps.recsys_step(rcell, cpu_off)(
            cpu_model, steps.batch_to(rb, "cpu"), cand)
        v1, i1 = steps.recsys_step(rcell, card_off)(
            card_model, steps.batch_to(rb, dev), cand.to(dev))
        if not _distinct_equal(i1, v0, i0):
            fail("phase 10c: retrieval top-k indices differ from the CPU's")
    finally:
        torch.use_deterministic_algorithms(False)
    rep = {"logits_max_abs": logit_err, "step": step,
           "embedding_bag_max_abs": bag_err,
           "retrieval_top_k_equal": True,
           "retrieval_scores_max_abs": float((v1.cpu() - v0).abs().max())}
    print("phase 10: 10c dcn-v2 smoke card vs cpu " + json.dumps(rep),
          flush=True)
    return rep


def _relu_sign_flips(dcn, steps, cfg, runs, batch) -> list:
    """For each MLP layer, the pre-activations whose sign differs between
    the float32 forwards of ``runs`` (``(model, offsets, device)``, the
    CPU's and the card's) on ``batch``: each is a ReLU kink that sends one
    example's gradient another way."""
    signs = []
    for model, off, where in runs:
        b = steps.batch_to(batch, where)
        with torch.no_grad():
            x0 = dcn.features(model, cfg, b, off)
            x = x0
            for i in range(cfg.n_cross_layers):
                p = model.cross[f"w_{i}"]
                x = x0 * (x @ p.kernel + p.bias) + x
            s = []
            for i in range(len(cfg.mlp)):
                z = x @ model.mlp[f"w_{i}"].kernel
                s.append((z > 0).cpu())
                x = torch.relu(z)
        signs.append(s)
    return [int((a != b).sum()) for a, b in zip(*signs)]


def recsys_train_bytes(cfg, n_params: int, table_rows: int) -> float:
    """Bytes a train step moves at least beyond the products, float32:
    the table's dense gradient written (zeros, then the adds), and AdamW
    reading the gradient and reading and writing the parameters and both
    moments, over every parameter."""
    return 4.0 * (table_rows * cfg.embed_dim + 7 * n_params)


def phase_10a(dev, steps) -> dict:
    """The full config at Criteo width (35.9M rows, seeded on the card):
    the B 512 forward and one B 2,048 train step against the CPU from the
    same weights, then ``train_batch``, ``serve_p99``, ``serve_bulk`` and
    ``retrieval_cand`` timed beside their bounds."""
    from repro_torch.models import dcn_v2 as dcn
    from repro_torch.models.gnn.common import params_to_numpy

    t_phase = time.perf_counter()
    out = {}
    gc.collect()
    torch.cuda.empty_cache()
    cell, model, opt, step = steps.build(
        RECSYS_ARCH, "train_batch", torch.Generator(device=dev).manual_seed(0),
        dev)
    del opt  # a fresh state after the check step below
    cfg = cell.cfg
    off = dcn.field_offsets(cfg, dev)
    n_params = sum(p.numel() for p in model.parameters())
    rows = int(sum(cfg.field_vocabs))
    out["params"] = n_params
    out["table_rows"] = rows
    out["build_s"] = time.perf_counter() - t_phase

    # -- the full width against the CPU from the same weights ---------------
    t0 = time.perf_counter()
    cpu_model, cpu_off = dcn.params_from_jax(params_to_numpy(model), cfg,
                                             "cpu")
    fcell = steps.recsys_cell(RECSYS_ARCH, "serve_p99",
                              dims=dict(batch=RECSYS_CHECK_B))
    fb = steps.recsys_batch(fcell, seed=11)
    with torch.no_grad():
        exp = dcn.forward(cpu_model, cfg, steps.batch_to(fb, "cpu"), cpu_off)
        got = dcn.forward(model, cfg, steps.batch_to(fb, dev), off)
    ok, fwd_err = _gnn_close(got, exp, RECSYS_TOL)
    if not ok or not bool(torch.isfinite(got).all()):
        fail(f"phase 10a: full-width logits card vs CPU off by {fwd_err}")
    tcell = steps.recsys_cell(RECSYS_ARCH, "train_batch",
                              dims=dict(batch=RECSYS_CHECK_TRAIN_B))
    tb = steps.recsys_batch(tcell, seed=12)
    flips = _relu_sign_flips(dcn, steps, cfg, ((cpu_model, cpu_off, "cpu"),
                                               (model, off, dev)), tb)
    # the step in float64 on both (see RECSYS_F64_TOL)
    cpu64 = cpu_model.double()
    card64 = copy.deepcopy(model).double()
    del cpu_model
    torch.use_deterministic_algorithms(True)
    try:
        cpu, card = _recsys_step_pair(steps, tcell, cpu64, card64, off, tb,
                                      dev, snapshot=_live_snapshot)
    finally:
        torch.use_deterministic_algorithms(False)
    del cpu64, card64
    out["check"] = {
        "forward_batch": RECSYS_CHECK_B, "logits_max_abs": fwd_err,
        "train_batch": RECSYS_CHECK_TRAIN_B,
        "float32_relu_sign_flips": flips,
        "float64_step": _gnn_step_check("10a dcn-v2 full width float64",
                                        cpu, card, steps.RECSYS_ADAMW.lr,
                                        tol=RECSYS_F64_TOL, where=dev),
        "seconds": time.perf_counter() - t0}
    del cpu, card
    gc.collect()
    opt = steps.adamw_init(steps.params_dict(model), steps.RECSYS_ADAMW)
    torch.cuda.empty_cache()

    # -- train_batch ---------------------------------------------------------
    B = cell.batch
    opt_ev: list = []
    adamw = steps.adamw_update

    def timed_adamw(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        r = adamw(*a, **kw)
        ev[1].record()
        opt_ev.append(ev)
        return r

    host = [steps.recsys_batch(cell, step=i) for i in range(GNN_WARM + 2)]

    def batches(i):
        t = time.perf_counter()
        b = steps.batch_to(host[i], dev)
        torch.cuda.synchronize()
        return b, (time.perf_counter() - t) * 1e3

    steps.adamw_update = timed_adamw
    try:
        run = gnn_train_timed(step, model, opt, batches, "10a train_batch")
    finally:
        steps.adamw_update = adamw
    torch.cuda.synchronize()
    adamw_ms = [a.elapsed_time(b) for a, b in opt_ev]
    ops_ms = cell.flops / F32_OPS_PER_S * 1e3
    byte_ms = recsys_train_bytes(cfg, n_params, rows) / HBM_BYTES_PER_S * 1e3
    out["train_batch"] = {
        "batch": B, **{k: v for k, v in run.items() if k != "steps"},
        "losses": [r["loss"] for r in run["steps"]],
        "h2d_ms": [r["prep_ms"] for r in run["steps"]],
        "examples_per_s": B / run["warm_ms"] * 1e3,
        "adamw_ms": float(np.median(adamw_ms[1:GNN_WARM + 1])),
        "adamw_ms_steps": adamw_ms,
        "bound_ms": max(ops_ms, byte_ms),
        "bound_by": "operations" if ops_ms >= byte_ms else "bytes",
        "bound_formula": f"3 x dcn_flops {cell.flops / 3:.4g} / "
                         f"{F32_OPS_PER_S:.3g} FLOP/s = {ops_ms:.4f} ms; "
                         f"table gradient and AdamW "
                         f"{recsys_train_bytes(cfg, n_params, rows):.4g} "
                         f"bytes = {byte_ms:.4f} ms",
        "bound_share": max(ops_ms, byte_ms) / run["warm_ms"]}
    del opt, step
    gc.collect()
    torch.cuda.empty_cache()
    model.requires_grad_(False)

    # -- serve_p99: host batch to host logits --------------------------------
    pcell = steps.recsys_cell(RECSYS_ARCH, "serve_p99")
    serve = steps.recsys_step(pcell, off)
    pb = [steps.recsys_batch(pcell, step=i, seed=1) for i in range(8)]

    def serve_host(b):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        return serve(model, batch).cpu()

    for b in pb[:2]:
        serve_host(b)  # warm
    ms = []
    for i in range(RECSYS_SERVE_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = serve_host(pb[i % len(pb)])
        ms.append((time.perf_counter() - t0) * 1e3)
        if not bool(torch.isfinite(logits).all()):
            fail("phase 10a: serve_p99 logits not finite")
    dev_b = steps.batch_to(pb[0], dev)
    fwd_ms = time_ms(lambda: serve(model, dev_b))
    p_ops = pcell.flops / F32_OPS_PER_S * 1e3
    out["serve_p99"] = {
        "batch": pcell.batch, "calls": len(ms),
        "p50_ms": float(np.percentile(ms, 50)),
        "p99_ms": float(np.percentile(ms, 99)), "max_ms": max(ms),
        "forward_ms": fwd_ms, "bound_ms": p_ops, "bound_by": "operations",
        "bound_formula": f"dcn_flops {pcell.flops:.4g} / "
                         f"{F32_OPS_PER_S:.3g} FLOP/s"}

    # -- serve_bulk ----------------------------------------------------------
    bcell = steps.recsys_cell(RECSYS_ARCH, "serve_bulk")
    bulk = steps.recsys_step(bcell, off)
    t0 = time.perf_counter()
    bh = steps.recsys_batch(bcell, seed=2)
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    bms = []
    for i in range(RECSYS_BULK_CALLS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = bulk(model, {k: torch.from_numpy(v).to(dev)
                              for k, v in bh.items()}).cpu()
        bms.append((time.perf_counter() - t0) * 1e3)
    if not bool(torch.isfinite(logits).all()) or logits.shape != (
            bcell.batch,):
        fail("phase 10a: serve_bulk logits not finite or misshapen")
    dev_bb = steps.batch_to(bh, dev)
    bfwd = time_ms(lambda: bulk(model, dev_bb), reps=3, rounds=3)
    b_ops = bcell.flops / F32_OPS_PER_S * 1e3
    warm_bulk = float(np.median(bms[1:]))
    out["serve_bulk"] = {
        "batch": bcell.batch, "cold_ms": bms[0], "ms": warm_bulk,
        "rows_per_s": bcell.batch / warm_bulk * 1e3,
        "forward_ms": bfwd, "forward_rows_per_s": bcell.batch / bfwd * 1e3,
        "host_batch_s": gen_s,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "bound_ms": b_ops, "bound_by": "operations",
        "bound_share": b_ops / bfwd,
        "bound_formula": f"dcn_flops {bcell.flops:.4g} / "
                         f"{F32_OPS_PER_S:.3g} FLOP/s"}
    del dev_bb, logits
    torch.cuda.empty_cache()

    # -- retrieval_cand --------------------------------------------------------
    rcell = steps.recsys_cell(RECSYS_ARCH, "retrieval_cand")
    retrieve = steps.recsys_step(rcell, off)
    cand = steps.retrieval_candidates(
        rcell, torch.Generator(device=dev).manual_seed(3))
    rb = steps.batch_to(steps.recsys_batch(rcell, seed=3), dev)
    vals, idx = retrieve(model, rb, cand)
    with torch.no_grad():
        q = dcn.query_embedding(model, cfg, rb, off).double()
        full = (q @ cand.double().T)[0]
    ref_v, ref_i = torch.sort(full, descending=True)
    k = steps.RETRIEVAL_TOP_K
    if idx.shape != (1, k) or not _distinct_equal(idx, ref_v[None, :k],
                                                  ref_i[None, :k]):
        fail("phase 10a: retrieval top-100 differs from a float64 sort")
    r_ms = time_ms(lambda: retrieve(model, rb, cand),
                   reps=RECSYS_RETRIEVAL_CALLS)
    cand_bytes = cand.numel() * cand.element_size()
    r_byte_ms = cand_bytes / HBM_BYTES_PER_S * 1e3
    r_ops_ms = rcell.flops / F32_OPS_PER_S * 1e3
    out["retrieval_cand"] = {
        "candidates": rcell.n_candidates, "ms": r_ms,
        "bound_ms": max(r_byte_ms, r_ops_ms),
        "bound_by": "bytes" if r_byte_ms >= r_ops_ms else "operations",
        "bound_formula": f"{cand_bytes} candidate bytes / "
                         f"{HBM_BYTES_PER_S:.3g} B/s; "
                         f"{rcell.flops:.4g} FLOP = {r_ops_ms:.4f} ms",
        "top5_indices": idx[0, :5].tolist(),
        "top5_scores": vals[0, :5].tolist(),
        "top100_digest": _digest(idx.cpu().numpy())}
    del cand, model
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    tr, sp, sb, rc = (out[k] for k in ("train_batch", "serve_p99",
                                       "serve_bulk", "retrieval_cand"))
    print(f"phase 10: 10a dcn-v2 full width ({n_params} parameters, "
          f"{rows} table rows): train_batch B {tr['batch']} warm step "
          f"{tr['warm_ms']:.2f} ms ({tr['examples_per_s']:.0f} examples/s, "
          f"AdamW {tr['adamw_ms']:.2f} ms; bound {tr['bound_ms']:.2f} ms), "
          f"peak {tr['peak_gb']:.2f} GB, idle "
          f"{tr['profile']['warm_idle_share']:.3f}; serve_p99 p50 "
          f"{sp['p50_ms']:.3f} ms, p99 {sp['p99_ms']:.3f} ms (forward "
          f"{sp['forward_ms']:.4f}, bound {sp['bound_ms']:.4f}); serve_bulk "
          f"{sb['ms']:.1f} ms, {sb['rows_per_s']:.0f} rows/s (forward "
          f"{sb['forward_ms']:.2f} ms, bound {sb['bound_ms']:.2f}); "
          f"retrieval_cand {rc['ms']:.4f} ms (bound {rc['bound_ms']:.4f})",
          flush=True)
    for key in ("check", "train_batch", "serve_p99", "serve_bulk",
                "retrieval_cand"):
        print(f"phase 10: 10a {key} " + json.dumps(out[key]), flush=True)
    return out


def minicpm_layer_shapes() -> dict:
    """One MiniCPM-2B layer's parameter shapes, from the model on ``meta``."""
    from repro_torch.configs import base
    from repro_torch.models.transformer import Layer

    cfg = base.get(LM_ARCH).full_config()
    layer = Layer(cfg, 0, None, torch.device("meta"))
    return {k: tuple(p.shape) for k, p in layer.named_parameters()}


def phase10_rank(rank: int, world: int, layer: dict, device: str) -> dict:
    """One of four gloo ranks sharing cuda:0: ``pipeline_apply`` over the
    four stages against the serial oracle, and ``compressed_psum`` of
    one MiniCPM-2B layer's gradient shapes on the card against the same
    ranks' sum of CPU tensors."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.compression import (
        compressed_psum,
        compression_init,
    )
    from repro_torch.parallel.pipeline import pipeline_apply

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    out = {"rank": rank}
    # -- pipeline --------------------------------------------------------------
    m, rows, d = PIPE_MICRO
    g = torch.Generator(device=dev).manual_seed(20)
    ws = torch.randn((world, d, d), generator=g, device=dev) / d ** 0.5
    xs = torch.randn((m, rows, d), generator=g, device=dev)
    mesh = make_mesh((world,), ("pipe",), dev)

    def stage(p, x):
        return torch.tanh(x @ p["W"])

    pipeline_apply(mesh, {"W": ws}, xs, stage)  # warm
    mesh.wire.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = pipeline_apply(mesh, {"W": ws}, xs, stage)
    torch.cuda.synchronize()
    pipe_ms = (time.perf_counter() - t0) * 1e3
    ref = []
    for x in xs:
        for s in range(world):
            x = stage({"W": ws[s]}, x)
        ref.append(x)
    err = float((got - torch.stack(ref)).abs().max())
    if not err <= PIPE_TOL:
        raise AssertionError(f"rank {rank}: pipeline off the serial oracle "
                             f"by {err}")
    out["pipeline"] = {"stages": world, "microbatches": m,
                       "microbatch": [rows, d], "ms": pipe_ms,
                       "max_abs_vs_serial": err,
                       "wire_calls": mesh.wire.calls,
                       "wire_bytes": mesh.wire.bytes,
                       "staged_bytes": mesh.wire.staged_bytes,
                       "digest": _digest(got.cpu().numpy())}
    del ws, xs, got, ref
    # -- compressed_psum -------------------------------------------------------
    data = make_mesh((world,), ("data",), dev)
    axes = data.axes("data")
    gg = torch.Generator(device=dev).manual_seed(100 + rank)
    grads = {k: torch.randn(s, generator=gg, device=dev) * 1e-3
             for k, s in layer.items()}
    state = compression_init(grads)
    compressed_psum(grads, state, axes)  # warm
    data.wire.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean, new = compressed_psum(grads, state, axes)
    torch.cuda.synchronize()
    c_ms = (time.perf_counter() - t0) * 1e3
    wire = dataclasses.asdict(data.wire)
    cpu_mean, cpu_new = compressed_psum(
        {k: v.cpu() for k, v in grads.items()},
        compression_init({k: v.cpu() for k, v in grads.items()}), axes)
    same = all(torch.equal(mean[k].cpu(), cpu_mean[k])
               and torch.equal(new.residual[k].cpu(), cpu_new.residual[k])
               for k in layer)
    if not same:
        raise AssertionError(f"rank {rank}: compressed_psum on the card "
                             "differs from the CPU's")
    n = sum(int(np.prod(s)) for s in layer.values())
    out["compressed_psum"] = {
        "leaves": len(layer), "elements": n, "ms": c_ms, "wire": wire,
        "float32_gradient_bytes": 4 * n, "bitwise_cpu": same,
        "digest": _digest(np.concatenate(
            [mean[k].cpu().numpy().ravel() for k in sorted(layer)]))}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def phase_10d() -> dict:
    """Four gloo ranks sharing the card (spawned as in phase 7):
    ``pipeline_apply`` and ``compressed_psum``."""
    from repro_torch.launch.mesh import run_ranks

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    layer = minicpm_layer_shapes()
    reps = run_ranks(phase10_rank, RANKS, (layer, f"{DEVICE}:0"),
                     backend="gloo", timeout_s=PHASE10_TIMEOUT_S,
                     threads=RANK_THREADS)
    for key in ("pipeline", "compressed_psum"):
        digests = {r[key]["digest"] for r in reps}
        if len(digests) != 1:
            fail(f"phase 10d: the ranks' {key} results differ")
    out = {"ranks": reps, "layer_shapes": {k: list(v)
                                           for k, v in layer.items()},
           "seconds": time.perf_counter() - t0}
    for r in reps:
        print(f"phase 10: 10d rank {r['rank']} " + json.dumps(r), flush=True)
    return out


def phase_10(dev, launches_before) -> dict:
    """Recsys (DCN-v2) and the mesh substrate's compression and pipeline
    (no kernel: JAX's EmbeddingBag is ``take`` and ``segment_sum``, its
    products plain ``@``)."""
    from repro_torch.launch import steps

    t0 = time.perf_counter()
    out = {"10c": phase_10c(dev, steps), "10a": phase_10a(dev, steps),
           "10d": phase_10d()}
    out["kernel_launches"] = launches_before()
    if any(out["kernel_launches"].values()):
        fail(f"phase 10 launched a port kernel: {out['kernel_launches']}")
    out["seconds"] = time.perf_counter() - t0
    print("phase 10: " + json.dumps({
        "kernel_launches": out["kernel_launches"],
        "seconds": out["seconds"],
        "10a_seconds": out["10a"]["seconds"],
        "10d_seconds": out["10d"]["seconds"]}), flush=True)
    return out


PAPER_ARCH = "paper-bfs-engine"
PAPER_SHAPES = ("ldbc100", "livejournal", "spotify", "graph500_28")
#: cuts of scale (node counts at the published degree laws), each forced by
#: the host's numpy generator: Spotify's 1.93B edges, and Graph500-28,
#: whose 64-lane state, contribution and ELL (85.4 GB) also exceed the card
PAPER_CUTS = {
    "spotify": {"n_nodes": 3_604_454 // 32},
    "graph500_28": {"n_nodes": 1 << 20},
}
PAPER_CUT_WHY = {
    "spotify": "the host's numpy generator: erdos_renyi's 1.93B edges at "
    "3,604,454 nodes (the 1/32 cut's 60M edges take about 23 s to build "
    "on the card's host, the whole about 12 min)",
    "graph500_28": "the card: 64-lane state and contribution (54.3 GB) and "
    "the 64-slot ELL (31.0 GB) exceed 80 GB; the host: numpy rmat draws "
    "2 x scale numbers an edge (scale 20's 33M edges take about 26 s)",
}
PAPER_SCIPY_LANES = 2  # lanes also held against scipy.sparse.csgraph
PAPER_GRAPH_TIMEOUT_S = 600  # a prefetched graph, or phase 11 fails


def paper_graph_timed(shape: str, n_nodes: int):
    """``shape``'s seeded graph at ``n_nodes`` nodes and the seconds it
    took (in the prefetch process)."""
    from repro_torch.launch.steps import paper_graph

    t0 = time.perf_counter()
    csr = paper_graph(shape, n_nodes)
    return csr, time.perf_counter() - t0


def prefetch_paper_graphs():
    """Start making phase 11's graphs (host numpy, about 100 s) in one
    spawned process, so that they are made while earlier phases use the
    card. Returns the pool (a daemon: it ends with this process at the
    latest) and each shape's pending ``paper_graph_timed``."""
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(1)
    return pool, {
        shape: pool.apply_async(paper_graph_timed, (shape, (
            PAPER_CUTS.get(shape) or cell_dims(shape))["n_nodes"]))
        for shape in PAPER_SHAPES}


def lane_bfs(csr, sources, cap: int, dev) -> torch.Tensor:
    """Level-synchronous BFS of each source over ``csr``'s edges, one
    lane after the other, in torch on ``dev``: ``[n, lanes]`` int16
    levels up to ``cap`` (-1 unreached; a source at or past ``n`` is an
    empty lane)."""
    n = csr.n_nodes
    src = torch.from_numpy(np.repeat(np.arange(n, dtype=np.int64),
                                     np.diff(csr.indptr))).to(dev)
    dst = torch.from_numpy(csr.indices.astype(np.int64)).to(dev)
    out = torch.full((n, len(sources)), -1, dtype=torch.int16, device=dev)
    for j, s in enumerate(int(x) for x in sources):
        if s >= n:
            continue
        lv = torch.full((n,), -1, dtype=torch.int16, device=dev)
        lv[s] = 0
        front = torch.zeros(n, dtype=torch.bool, device=dev)
        front[s] = True
        for d in range(1, cap + 1):
            nxt = torch.zeros(n, dtype=torch.bool, device=dev)
            nxt[dst[front[src]]] = True
            nxt &= lv < 0
            if not bool(nxt.any()):
                break
            lv[nxt] = d
            front = nxt
        out[:, j] = lv
    return out


def check_paper_cell(shape: str, keep: dict, dev) -> dict:
    """The card cell's levels and per-morsel trips against ``lane_bfs`` of
    the cut edge set (every lane), and ``PAPER_SCIPY_LANES`` lanes against
    ``scipy.sparse.csgraph.shortest_path`` on the host."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path

    t0 = time.perf_counter()
    cell, bound, res = keep["cell"], keep["bound"], keep["result"]
    cap = cell.config.max_iters
    csr, n = bound.csr, bound.csr.n_nodes
    levels, iters = res.state.levels, res.iterations
    for m in range(bound.morsels.shape[0]):
        ref = lane_bfs(csr, bound.morsels[m], cap, dev)
        got = levels[m].to(dev)
        exp = torch.where(ref >= 0, ref, 255).to(torch.uint8)
        if not torch.equal(got[:n], exp):
            bad = int((got[:n] != exp).sum())
            fail(f"phase 11 {shape}: morsel {m} levels differ from the "
                 f"independent BFS at {bad} entries")
        if bool((got[n:] != 255).any()):
            fail(f"phase 11 {shape}: a pad row is reached in morsel {m}")
        live = ref.max() if bool((ref >= 0).any()) else None
        want = 0 if live is None else min(cap, int(live) + 1)
        if int(iters[m]) != want:
            fail(f"phase 11 {shape}: morsel {m} ran {int(iters[m])} trips, "
                 f"the BFS needs {want}")
    a = csr_matrix((np.ones(csr.n_edges, np.float32), csr.indices,
                    csr.indptr), shape=(n, n))
    srcs = [int(x) for x in bound.sources[:PAPER_SCIPY_LANES]]
    dist = shortest_path(a, method="D", unweighted=True, indices=srcs)
    sp = np.where(dist <= cap, dist, 255).astype(np.uint8)
    got = levels[0, :n, :len(srcs)].cpu().numpy().T
    if not np.array_equal(got, sp):
        fail(f"phase 11 {shape}: lanes {srcs} differ from scipy's BFS")
    return {"seconds": time.perf_counter() - t0, "lanes": int(
        levels.shape[-1]) * levels.shape[0], "scipy_lanes": len(srcs)}


def phase_11(dev, launches_before, graphs=None) -> dict:
    """The paper engine's Table 2 cells (``launch/dryrun.py``, the cell
    builder of ``launch/steps.py``; no kernel: the cell's engine extends
    by ``ell_push``, as JAX's ``build_engine`` default does). ``graphs``,
    from ``prefetch_paper_graphs``, holds each cell's graph in the making;
    without it ``run_cell`` makes the graph itself."""
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    out_dir = str(ROOT / "results" / "dryrun_torch")
    out = {"cells": {}, "layouts": {}, "reduced": []}
    for shape in PAPER_SHAPES:
        gc.collect()
        torch.cuda.empty_cache()
        keep = {}
        cut = PAPER_CUTS.get(shape)
        t1 = time.perf_counter()
        graph, graph_s = (graphs[shape].get(PAPER_GRAPH_TIMEOUT_S)
                          if graphs else (None, None))
        wait_s = time.perf_counter() - t1
        rec = dryrun.run_cell(PAPER_ARCH, shape, "card", out_dir,
                              force=True, device=dev, cut=cut, keep=keep,
                              csr=graph)
        del graph
        if rec["status"] != "ok":
            fail(f"phase 11 {shape}: {rec.get('error')}\n"
                 f"{rec.get('traceback', '')}")
        chk = check_paper_cell(shape, keep, dev)
        # where a warm run's time goes (one more run, under the profiler)
        prof = gnn_profile(keep["bound"]) if dev.type == "cuda" else None
        keep.clear()
        rl = rec["roofline"]
        summary = {k: rec[k] for k in (
            "notes", "n_nodes", "n_edges_generated", "n_edges_cut",
            "wall_ms", "wall_ms_runs", "cold_ms", "bind_s", "iterations",
            "edges_scanned", "gteps", "bound_ms",
            "state_plus_contribution_bytes", "fits_80g_hbm")}
        dims = cell_dims(shape)
        summary.update(
            published={k: dims[k] for k in ("n_nodes", "n_edges")},
            peak_bytes=rec["memory"]["total_bytes_per_device"],
            argument_bytes=rec["memory"]["argument_size_in_bytes"],
            roofline={k: rl[k] for k in ("compute_s", "memory_s",
                                         "collective_s", "dominant")},
            check=chk, profile=prof, graph_s=graph_s,
            graph_wait_s=wait_s if graphs else None,
            seconds=time.perf_counter() - t1)
        if cut:
            out["reduced"].append({"cell": shape, **cut,
                                   "why": PAPER_CUT_WHY[shape]})
        out["cells"][shape] = summary
        print(f"phase 11: {shape} " + json.dumps(summary), flush=True)
    for mesh_tag in ("single", "multi"):
        for shape in PAPER_SHAPES:
            rec = dryrun.run_cell(PAPER_ARCH, shape, mesh_tag, out_dir,
                                  force=True)
            if rec["status"] != "ok":
                fail(f"phase 11d {shape} on {mesh_tag}: {rec.get('error')}")
            out["layouts"][f"{shape}/{mesh_tag}"] = rec
            print(f"phase 11: 11d {shape} {mesh_tag} " + json.dumps(rec),
                  flush=True)
    out["kernel_launches"] = launches_before()
    if any(out["kernel_launches"].values()):
        fail(f"phase 11 launched a port kernel: {out['kernel_launches']}")
    out["seconds"] = time.perf_counter() - t0
    print("phase 11: " + json.dumps({
        "kernel_launches": out["kernel_launches"],
        "reduced": out["reduced"], "seconds": out["seconds"]}), flush=True)
    return out


# -- phase 12: the LM serving cells on a mesh of ranks -------------------------

PHASE12_MESH = (2, 2)  # ("data", "model"): 4 gloo ranks sharing the card
PHASE12_STEPS = 2  # decode steps against the 4 x 4,128 cache
#: MiniCPM-2B's 40 layers cut to 2 at full width, so that the whole run
#: stays inside its time limit with phases 14 and 15 (PERF.md names the
#: cut)
PHASE12_LAYERS = 2
PHASE12_TIMEOUT_S = 600  # the rank group, or it fails
#: mesh against one rank, bfloat16: phase 6b's tolerance for the kernel
#: route against the scan route, a logits row's cosine similarity; greedy
#: tokens must agree wherever the one-rank top-2 margin exceeds twice the
#: row's largest logit difference (no difference that small can swap them)
PHASE12_COS = LM_COS


def phase12_spec():
    """MiniCPM-2B with its full config cut to ``PHASE12_LAYERS``."""
    from repro_torch.configs import base

    spec = base.get(LM_ARCH)
    cfg = dataclasses.replace(spec.full_config(), n_layers=PHASE12_LAYERS)
    return dataclasses.replace(spec, full_config=lambda: cfg)


def phase12_cells(mesh):
    """MiniCPM-2B's prefill and decode cells at the phase's cuts:
    ``prefill_32k`` 32 x 32,768 -> 4 x 4,096 and ``decode_32k``'s cache
    128 x 32,768 -> 4 x 4,128 (``LM_PROMPTS``, ``LM_STEPS``' cache), at
    ``PHASE12_LAYERS`` layers."""
    from repro_torch.launch import steps

    spec = phase12_spec()
    b, s = LM_PROMPTS
    shapes = {x.name: x for x in spec.shapes}
    pre = dataclasses.replace(shapes["prefill_32k"], dims=dict(
        seq_len=s, global_batch=b))
    dec = dataclasses.replace(shapes["decode_32k"], dims=dict(
        seq_len=s + LM_STEPS, global_batch=b))
    return (steps._lm_cell(spec, pre, mesh, False),
            steps._lm_cell(spec, dec, mesh, False))


def _spec_block(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``, cut with ``chunk`` (a
    second way than ``nn.module.block_of``'s slices)."""
    for d, part in enumerate(spec):
        axes = (part,) if isinstance(part, str) else tuple(part or ())
        idx, k = 0, 1
        for a in axes:
            idx = idx * mesh.shape[a] + mesh.coord(a)
            k *= mesh.shape[a]
        if k > 1:
            t = t.chunk(k, dim=d)[idx]
    return t


def _wire(mesh) -> dict:
    w = mesh.wire
    return {"calls": w.calls, "payload_bytes": w.bytes,
            "staged_bytes": w.staged_bytes, "ms": w.ms,
            "by_kind": {k: {str(g): v for g, v in d.items()}
                        for k, d in w.by_kind.items()},
            "by_axis": w.by_axis, "staged_by_kind": dict(w.staged_by_kind)}


def phase12_rank(rank: int, world: int, prompts: np.ndarray,
                 forced: np.ndarray, device: str) -> dict:
    """One of four gloo ranks sharing the card: MiniCPM-2B (seed 0, as
    the one-rank run) cut by ``steps.shard_lm`` on the ``(2, 2)`` mesh,
    every block checked against the spec's slice; a cold and a warm
    prefill of ``prompts`` into the decode cell's cache layout, then
    ``PHASE12_STEPS`` decode steps fed ``forced`` (the one-rank run's
    greedy tokens). Returns the global logits (rank 0), timings, kernel
    launches, the collectives of the warm prefill and of the decode, and
    peak device memory."""
    from repro_torch.kernels.block_spmm import block_spmm as bs_mod
    from repro_torch.kernels.binned_pull import binned_pull as bp_mod
    from repro_torch.kernels.flash_attention import flash_attention as fa_mod
    from repro_torch.kernels.msbfs_extend import msbfs_extend as mx_mod
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.nn import attention as attn
    from repro_torch.nn.module import gather_block

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    counters = {"binned_pull": bp_mod.fused_binned_pull,
                "msbfs_extend": mx_mod.msbfs_extend_blocks,
                "block_spmm": bs_mod.block_spmm,
                "flash_attention": fa_mod.flash_attention}
    mesh = make_mesh(PHASE12_MESH, ("data", "model"), dev)
    pcell, dcell = phase12_cells(mesh)
    cfg = pcell.config
    t0 = time.perf_counter()
    model = tfm.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    whole = dict(model.named_parameters())
    steps.shard_lm(pcell, model, mesh)
    blocks_ok, sharded = True, 0
    for name, p in model.named_parameters():
        want = _spec_block(whole[name], model.shard_specs[name], mesh)
        blocks_ok &= torch.equal(p, want)
        sharded += p.shape != whole[name].shape
    del whole, want
    gc.collect()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    toks = torch.from_numpy(prompts).to(dev)
    feed = torch.from_numpy(forced).to(dev)
    b, s = prompts.shape
    out = {"rank": rank, "coords": {a: mesh.coord(a)
                                    for a in mesh.axis_names},
           "blocks_equal_spec": bool(blocks_ok), "sharded_params": sharded,
           "init_s": init_s}

    def zero():
        for f in counters.values():
            f.launches = 0
        attn.route_calls.update(dict.fromkeys(attn.route_calls, 0))

    def prefill():
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = pcell.fn(model, toks, max_seq=s + LM_STEPS)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t) * 1e3

    zero()
    (_, caches), cold_ms = prefill()
    del caches
    out["cold_launches"] = {k: f.launches for k, f in counters.items()}
    zero()
    mesh.wire.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    (logits, caches), warm_ms = prefill()
    out["prefill_wire"] = _wire(mesh)
    out["launches"] = {k: f.launches for k, f in counters.items()}
    out["route_calls"] = dict(attn.route_calls)
    out["prefill_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    spec = pcell.decisions["out_specs"][0]
    rows = [gather_block(logits, spec, mesh)[:, :cfg.vocab].float().cpu()]
    zero()
    mesh.wire.reset()
    step_ms = []
    for t in range(feed.shape[1]):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        o, caches = dcell.fn(model, caches, feed[:, t:t + 1], s + t)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        rows.append(gather_block(o[:, 0], spec, mesh)[:, :cfg.vocab]
                    .float().cpu())
    out["decode_wire"] = _wire(mesh)  # the logits' gathers included
    out["decode_launches"] = {k: f.launches for k, f in counters.items()}
    out.update(prefill_cold_ms=cold_ms, prefill_ms=warm_ms,
               decode_step_ms=step_ms,
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               cache_block=list(caches[0].k.shape),
               digest=_digest(torch.stack(rows).numpy()))
    if rank == 0:
        out["logits"] = [r.numpy() for r in rows]
    return out


def phase_12(dev, one_rank_6b=None) -> dict:
    """MiniCPM-2B's prefill and decode cells sharded over a ``(2, 2)``
    mesh of four gloo ranks sharing the card, against a one-rank run of
    the same weights on the card (the steps in the module docstring)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa_mod
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import transformer as tfm
    from repro_torch.nn import attention as attn

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    fa = fa_mod.flash_attention
    cfg = phase12_spec().full_config()
    b, s = LM_PROMPTS
    max_seq = s + LM_STEPS
    rng = np.random.default_rng(12)
    prompts = rng.integers(0, cfg.vocab, (b, s))
    # the one-rank reference: the same seeded weights, greedy decode
    model = tfm.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    toks = torch.from_numpy(prompts).to(dev)
    tfm.prefill(model, cfg, toks, max_seq=max_seq)  # cold
    torch.cuda.synchronize()
    launches = fa.launches
    t1 = time.perf_counter()
    last, caches = tfm.prefill(model, cfg, toks, max_seq=max_seq)
    torch.cuda.synchronize()
    one = {"prefill_ms": (time.perf_counter() - t1) * 1e3,
           "launches": fa.launches - launches}
    ref = [last[:, :cfg.vocab].float()]
    fed, step_ms = [], []
    for t in range(PHASE12_STEPS):
        tok = ref[-1].argmax(-1, keepdim=True)
        fed.append(tok)
        t1 = time.perf_counter()
        o, caches = tfm.decode(model, cfg, caches, tok, s + t)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        ref.append(o[:, 0, :cfg.vocab].float())
    one["decode_ms_per_step"] = float(np.median(step_ms))
    one["decode_step_ms"] = step_ms
    ref = [r.cpu() for r in ref]
    forced = torch.cat(fed, dim=1).cpu().numpy()
    del model, last, caches, o, toks
    gc.collect()
    torch.cuda.empty_cache()
    if one["launches"] != cfg.n_layers:
        fail(f"phase 12: the one-rank prefill launched mha "
             f"{one['launches']} times, not {cfg.n_layers}")
    # the mesh
    t1 = time.perf_counter()
    reps = run_ranks(phase12_rank, RANKS, (prompts, forced, f"{DEVICE}:0"),
                     backend="gloo", timeout_s=PHASE12_TIMEOUT_S,
                     threads=RANK_THREADS)
    ranks_s = time.perf_counter() - t1
    if len({r["digest"] for r in reps}) != 1:
        fail("phase 12: the ranks' gathered logits differ")
    got = [torch.from_numpy(x) for x in reps[0]["logits"]]
    rows = []
    for t, (g, r) in enumerate(zip(got, ref)):
        cos = torch.nn.functional.cosine_similarity(g.double(), r.double(),
                                                    dim=-1)
        delta = (g - r).abs().max(dim=-1).values
        top2 = r.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        clear = margin > 2 * delta
        agree = g.argmax(-1) == r.argmax(-1)
        rows.append({"step": t, "min_cosine": float(cos.min()),
                     "max_abs": float(delta.max()),
                     "max_rel": float(delta.max() / r.abs().max()),
                     "tokens_clear": int(clear.sum()),
                     "tokens_equal": int(agree.sum()),
                     "clear_and_unequal": int((clear & ~agree).sum())})
        if float(cos.min()) < PHASE12_COS or bool((clear & ~agree).any()):
            fail(f"phase 12: mesh against one rank at step {t}: "
                 f"{rows[-1]}")
        if not torch.isfinite(g).all():
            fail(f"phase 12: mesh logits not finite at step {t}")
    n_l = cfg.n_layers
    for r in reps:
        if not r["blocks_equal_spec"] or not r["sharded_params"]:
            fail(f"phase 12: rank {r['rank']}'s parameter blocks are not "
                 "the spec's slices")
        for what in ("cold_launches", "launches"):
            want = {"binned_pull": 0, "msbfs_extend": 0, "block_spmm": 0,
                    "flash_attention": n_l}
            if r[what] != want:
                fail(f"phase 12: rank {r['rank']} {what} {r[what]}, not "
                     f"{want}")
        if r["route_calls"] != {"kernel": n_l, "scan": 0}:
            fail(f"phase 12: rank {r['rank']} route calls "
                 f"{r['route_calls']}")
        if any(r["decode_launches"].values()):
            fail(f"phase 12: rank {r['rank']} decode launched "
                 f"{r['decode_launches']}")
        ax = r["prefill_wire"]["by_axis"]
        if not (ax.get("data", {}).get("all-gather", [0])[0] > 0
                and ax.get("model", {}).get("all-gather", [0])[0] > 0
                and ax.get("model", {}).get("reduce-scatter", [0])[0] > 0):
            fail(f"phase 12: rank {r['rank']} collectives by axis {ax}")
    prefill_ms = max(r["prefill_ms"] for r in reps)
    step = float(np.median([max(r["decode_step_ms"][t] for r in reps)
                            for t in range(PHASE12_STEPS)]))
    for r in reps:
        r.pop("logits", None)
    out = {
        "arch": cfg.name, "mesh": list(PHASE12_MESH), "dtype": "bfloat16",
        "n_layers": PHASE12_LAYERS, "prompts": [b, s], "max_seq": max_seq,
        "decode_steps": PHASE12_STEPS,
        "prefill_ms": prefill_ms,
        "prefill_cold_ms": max(r["prefill_cold_ms"] for r in reps),
        "prefill_tokens_per_s": b * s / (prefill_ms / 1e3),
        "decode_ms_per_step": step,
        "decode_tokens_per_s": b / (step / 1e3),
        "mha_launches_per_prefill": [r["launches"]["flash_attention"]
                                     for r in reps],
        "vs_one_rank": rows, "tolerance": {"min_cosine": PHASE12_COS,
                                           "greedy": "margin > 2 max_abs"},
        "one_rank": {**one, "prefill_tokens_per_s":
                     b * s / (one["prefill_ms"] / 1e3),
                     "decode_tokens_per_s":
                     b / (one["decode_ms_per_step"] / 1e3)},
        "phase_6b": None if one_rank_6b is None else {
            k: one_rank_6b[k] for k in (
                "prefill_ms", "prefill_tokens_per_s", "decode_ms_per_step",
                "decode_tokens_per_s", "peak_gb")},
        "ranks": reps, "ranks_s": ranks_s,
        "seconds": time.perf_counter() - t0,
    }
    for r in reps:
        pw, dw = r["prefill_wire"], r["decode_wire"]
        print(f"phase 12: rank {r['rank']} {r['coords']}: prefill "
              f"{r['prefill_ms']:.1f} ms (cold {r['prefill_cold_ms']:.1f}), "
              f"collectives {pw['ms']:.1f} ms, payload "
              f"{pw['payload_bytes'] / 1e9:.3f} GB, staged "
              f"{pw['staged_bytes'] / 1e9:.3f} GB by kind "
              f"{pw['staged_by_kind']}; decode {PHASE12_STEPS} steps "
              f"{sum(r['decode_step_ms']):.1f} ms, collectives "
              f"{dw['ms']:.1f} ms, staged {dw['staged_bytes'] / 1e9:.3f} GB;"
              f" peak {r['peak_gb']:.3f} GB; cache block "
              f"{r['cache_block']}", flush=True)
    print(f"phase 12: {cfg.name} ({cfg.n_layers} layers) on a "
          f"{PHASE12_MESH} mesh of {RANKS} gloo "
          f"ranks: prefill [{b}, {s}] {prefill_ms:.1f} ms "
          f"({out['prefill_tokens_per_s']:.0f} tokens/s), decode "
          f"{step:.1f} ms a step ({out['decode_tokens_per_s']:.1f} "
          f"tokens/s); one rank on the card: prefill "
          f"{one['prefill_ms']:.1f} ms, decode "
          f"{one['decode_ms_per_step']:.1f} ms a step"
          + ("" if one_rank_6b is None else
             f" (phase 6b, {lm_config().n_layers} layers: prefill "
             f"{one_rank_6b['prefill_ms']:.1f} ms, "
             f"decode {one_rank_6b['decode_ms_per_step']:.1f} ms a step)")
          + f"; min cosine {min(x['min_cosine'] for x in rows):.6f}; "
          f"{torch.cuda.get_device_name(dev)}; {out['seconds']:.1f} s",
          flush=True)
    return out


# -- phase 13: the GNN and recsys cells on a mesh of ranks -------------------

PHASE13_MESH = (2, 2)  # ("data", "model"): 4 gloo ranks sharing the card
PHASE13_STEPS = 2  # GNN AdamW steps, on the mesh and on one rank
PHASE13_TIMEOUT_S = 900  # the rank group, or it fails
#: (arch, shape, dtype) at the full configs: PNA in float64 (a sampled
#: tree's in-degree-0 leaves make float32 rounding swamp its first
#: layers' gradient, phase 9a), the others in float32
PHASE13_GNN = (("pna", "full_graph_sm", torch.float64),
               ("pna", "minibatch_lg", torch.float64),
               ("schnet", "molecule", torch.float32),
               ("mace", "molecule", torch.float32),
               ("equiformer-v2", "molecule", torch.float32))
PHASE13_SMOKE = False  # a CPU rehearsal builds the smoke configs
#: layers of the full configs on the mesh and the one-rank reference:
#: PNA's 4 and EquiformerV2's 12 cut, widths kept, so that the whole run
#: stays inside its time limit with phases 14 and 15 (PERF.md names the
#: cuts)
PHASE13_LAYERS = {"pna": 1, "equiformer-v2": 2}
PHASE13_DIMS: dict = {}  # a CPU rehearsal's smaller shapes, by shape name
PHASE13_CALLS = {"serve_p99": 10, "serve_bulk": 1, "retrieval_cand": 3}
PHASE13_CHECK_B = RECSYS_CHECK_TRAIN_B  # the float64 DCN-v2 step's batch
PHASE13_TRAIN_B = 65536  # train_batch's own batch, float32, timed
PHASE13_CAND_SEED = 13
# mesh against one rank on the card: float64 per leaf at GNN_F64_TOL,
# parameters within GNN_PARAM_ABS; float32 (the ranks' sums add in other
# orders) the loss at GNN_TOL, the norm at GNN_GRAD_TOL's rtol, moments
# at GNN_GRAD_TOL per leaf, each parameter leaf within 0.1 lr but for one
# entry or 1% of them (a rounding-sized gradient's sign decides a first
# AdamW step) and all of it within 2 lr a step


@contextlib.contextmanager
def phase13_depth():
    """The registry's PNA and EquiformerV2 with ``PHASE13_LAYERS``
    layers for a ``with`` block (``steps.gnn_cell`` reads the registry);
    the full configs come back after it."""
    from repro_torch.configs import base

    saved = {a: base.get(a) for a in PHASE13_LAYERS}
    for a, n in PHASE13_LAYERS.items():
        cfg = dataclasses.replace(saved[a].full_config(), n_layers=n)
        base.REGISTRY[a] = dataclasses.replace(
            saved[a], full_config=lambda cfg=cfg: cfg)
    try:
        yield
    finally:
        base.REGISTRY.update(saved)


def phase13_cell(mesh, arch: str, shape: str, dims=None):
    from repro_torch.launch import steps

    d = {**PHASE13_DIMS.get(shape, {}), **(dims or {})}
    return steps.build_cell(arch, shape, mesh, False, smoke=PHASE13_SMOKE,
                            dims=d or None)


def phase13_gnn_batches(dev, csr) -> dict:
    """The global numpy batches of each GNN case: ``cell_batch`` seeds
    0 and 1; PNA ``minibatch_lg`` sampled on the card from the scale-10
    proxy's forward ELL as phase 9a samples (``GraphSeedStream`` seeds,
    fanouts (15, 10), the seeded feature table)."""
    from repro_torch.data.pipeline import GraphSeedStream
    from repro_torch.graph import sampler
    from repro_torch.graph.csr import ell_from_csr
    from repro_torch.kernels.common import to_device
    from repro_torch.launch import steps

    out = {}
    for arch, shape, _ in PHASE13_GNN:
        dims = PHASE13_DIMS.get(shape)
        cell = steps.gnn_cell(arch, shape, smoke=PHASE13_SMOKE, dims=dims)
        if shape != "minibatch_lg" or arch != "pna":
            out[arch, shape] = [steps.cell_batch(cell, seed=i)
                                for i in range(PHASE13_STEPS)]
            continue
        ell = to_device(ell_from_csr(csr), dev)
        feats = torch.randn((csr.n_nodes, cell.cfg.d_feat),
                            generator=torch.Generator().manual_seed(
                                GNN_FEAT_SEED))
        eye = np.eye(cell.cfg.n_out, dtype=np.float32)
        stream = GraphSeedStream(n_nodes=csr.n_nodes,
                                 batch_nodes=cell.seeds,
                                 n_classes=cell.cfg.n_out)
        gen = torch.Generator(device=dev).manual_seed(1)
        batches = []
        for i in range(PHASE13_STEPS):
            sb = stream.batch(i)
            sub = sampler.sample_subgraph(ell, sb["seeds"], cell.fanout, gen,
                                          device=dev)
            nodes = sub.nodes.long().cpu()
            batches.append({
                "edge_src": sub.edge_src.cpu().numpy(),
                "edge_dst": sub.edge_dst.cpu().numpy(),
                "node_feat": feats[nodes].numpy(),
                "targets": eye[sb["labels"]]})
        out[arch, shape] = batches
        del ell
    return out


def _phase13_gnn_model(steps, cell, arch, dtype, dev):
    gc_ = steps.gnn_cell(arch, cell.shape_name, smoke=PHASE13_SMOKE,
                         dims=PHASE13_DIMS.get(cell.shape_name))
    model = steps.init_model(gc_, torch.Generator(device=dev).manual_seed(0),
                             dev)
    return model.to(dtype) if dtype != torch.float32 else model


def _state(model, opt, mesh=None) -> dict:
    """Parameters and moments on the host (gathered whole on a mesh)."""
    from repro_torch.nn.module import gather_block

    def whole(name, t):
        t = t.detach()
        if mesh is not None:
            t = gather_block(t, model.shard_specs[name], mesh)
        return t.to("cpu", copy=True)

    return {"params": {k: whole(k, p) for k, p in model.named_parameters()},
            "mu": {k: whole(k, v) for k, v in opt.mu.items()},
            "nu": {k: whole(k, v) for k, v in opt.nu.items()}}


def _timed(fn, dev):
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    res = fn()
    torch.cuda.synchronize(dev)
    return res, (time.perf_counter() - t) * 1e3


def _wire13(mesh) -> dict:
    w = mesh.wire
    return {"calls": w.calls, "payload_bytes": w.bytes,
            "staged_bytes": w.staged_bytes, "ms": w.ms,
            "ms_by_kind": dict(w.ms_by_kind),
            "by_axis": {a: {k: list(v) for k, v in d.items()}
                        for a, d in w.by_axis.items()},
            "staged_by_kind": dict(w.staged_by_kind)}


def phase13_gnn_run(mesh, batches: dict, dev) -> dict:
    """Each GNN case's ``PHASE13_STEPS`` train steps on ``mesh`` (a
    one-rank mesh: the reference): step ms, losses and norms, the state
    after (gathered whole; on a mesh rank 0's only), collectives against
    the schedule, blocks against their specs, the slab layout and peak
    device memory."""
    from repro_torch.launch import steps
    from repro_torch.optim.adamw import adamw_init

    out = {}
    for arch, shape, dtype in PHASE13_GNN:
        torch.cuda.reset_peak_memory_stats(dev)
        cell = phase13_cell(mesh, arch, shape)
        model = _phase13_gnn_model(steps, cell, arch, dtype, dev)
        whole = {k: p.detach().clone() for k, p in model.named_parameters()}
        model.requires_grad_(True)
        steps.shard_gnn(cell, model, mesh)
        blocks_ok = all(torch.equal(p, _spec_block(
            whole[k], model.shard_specs[k], mesh))
            for k, p in model.named_parameters())
        del whole
        opt = adamw_init(steps.params_dict(model), steps.GNN_ADAMW)
        rbs = []
        for b in batches[arch, shape]:
            rb, layout = steps.gnn_rank_batch(cell, mesh,
                                              steps.pad_gnn_batch(cell, b))
            rbs.append(rb)
        mesh.wire.reset()
        losses, ms = [], []
        for rb in rbs:
            (_, opt, loss, gnorm), t = _timed(
                lambda rb=rb: cell.fn(model, opt, rb), dev)
            losses.append((float(loss), float(gnorm)))
            ms.append(t)
        wire = _wire13(mesh)
        sched = steps.gnn_collective_schedule(cell, mesh.shape,
                                              el=torch.finfo(dtype).bits // 8)
        want = {a: {k: [PHASE13_STEPS * c, PHASE13_STEPS * n]
                    for k, (c, n) in d.items()} for a, d in sched.items()}
        rec = {"dtype": str(dtype).split(".")[-1], "steps": losses,
               "step_ms": ms, "wire": wire,
               "schedule_equal": wire["by_axis"] == want,
               "blocks_ok": blocks_ok, "layout": layout,
               "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
               "notes": cell.notes}
        if mesh.size == 1 or mesh.rank == 0:
            rec["state"] = _state(model, opt,
                                  mesh if mesh.size > 1 else None)
        elif mesh.size > 1:
            _state(model, opt, mesh)  # the gathers are collective
        out[f"{arch}/{shape}"] = rec
        if mesh.size == 1 or mesh.rank == 0:
            print(f"phase 13: {'one rank' if mesh.size == 1 else 'rank 0'} "
                  f"{arch}/{shape}: step ms {[round(x, 2) for x in ms]}, "
                  f"peak {rec['peak_gb']:.3f} GB", flush=True)
        del model, opt, rbs
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _dcn_touched(cfg, batch) -> np.ndarray:
    off = np.concatenate([[0], np.cumsum(cfg.field_vocabs)[:-1]])
    return np.unique(batch["sparse"].astype(np.int64) + off[None, :])


def phase13_dcn_run(mesh, dev) -> dict:
    """DCN-v2 at the full config on ``mesh`` (seed 0 weights; a one-rank
    mesh: the reference): ``serve_p99``, ``serve_bulk`` and
    ``retrieval_cand`` from the initial weights (logits gathered whole,
    the merged top 100), one float64 ``train_batch`` step at
    ``PHASE13_CHECK_B`` on a copy (loss, norm, every leaf but the table
    whole; the table's rows the batch touches, and whether every other
    row's moments stayed 0), then two float32 steps at
    ``PHASE13_TRAIN_B``, timed; each kind's collectives against the
    schedule."""
    from repro_torch.launch import steps
    from repro_torch.models import dcn_v2 as dcn
    from repro_torch.nn.module import gather_block, part_axes
    from repro_torch.optim.adamw import adamw_init

    out = {}
    torch.cuda.reset_peak_memory_stats(dev)
    cells = {s: phase13_cell(mesh, RECSYS_ARCH, s) for s in
             ("serve_p99", "serve_bulk", "retrieval_cand")}
    cells["check"] = phase13_cell(mesh, RECSYS_ARCH, "train_batch",
                                  dict(batch=PHASE13_CHECK_B))
    cells["train_batch"] = phase13_cell(mesh, RECSYS_ARCH, "train_batch",
                                        dict(batch=PHASE13_TRAIN_B))
    cfg = cells["check"].config
    model = dcn.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)[0]
    whole = {k: p.detach().clone() for k, p in model.named_parameters()}
    steps.shard_recsys(cells["train_batch"], model, mesh)
    blocks_ok = all(torch.equal(p, _spec_block(
        whole[k], model.shard_specs[k], mesh))
        for k, p in model.named_parameters())
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    out["blocks_ok"] = blocks_ok
    for s in ("serve_p99", "serve_bulk", "retrieval_cand"):
        cell = cells[s]
        rc = steps.recsys_cell(RECSYS_ARCH, s, smoke=PHASE13_SMOKE,
                               dims=PHASE13_DIMS.get(s))
        cand = None
        if s == "retrieval_cand":
            cand = torch.randn(
                (cell.decisions["n_candidates_padded"], cfg.retrieval_dim),
                generator=torch.Generator(device=dev).manual_seed(
                    PHASE13_CAND_SEED), device=dev)
        b, c = steps.recsys_rank_batch(cell, mesh,
                                       steps.recsys_batch(rc, seed=13), cand)
        args = (model, b) + ((c,) if c is not None else ())
        cell.fn(*args)  # cold
        mesh.wire.reset()
        ms = []
        for _ in range(PHASE13_CALLS[s]):
            res, t = _timed(lambda: cell.fn(*args), dev)
            ms.append(t)
        wire = _wire13(mesh)
        sched = steps.recsys_collective_schedule(cell, mesh.shape)
        n = PHASE13_CALLS[s]
        want = {a: {k: [n * x, n * y] for k, (x, y) in d.items()}
                for a, d in sched.items()}
        rec = {"call_ms": ms, "wire": wire,
               "schedule_equal": wire["by_axis"] == want,
               "batch": rc.batch}
        if s == "retrieval_cand":
            rec["values"], rec["indices"] = (x.cpu() for x in res)
            rec["cand_rows"] = int(c.shape[0])
            if mesh.size == 1:  # the one-rank top 100 against float64
                with torch.no_grad():
                    q = dcn.query_embedding(model, cfg, b, dcn.field_offsets(
                        cfg, dev))
                    ref = torch.sort(q.double() @ c.double().T, dim=-1,
                                     descending=True)
                ok, err = _gnn_close(res[0], ref.values[:, :100],
                                     RECSYS_TOL)
                rec["float64_sort"] = {
                    "max_abs": err, "values_ok": ok,
                    "indices_equal_where_distinct": _distinct_equal(
                        res[1], ref.values[:, :100], ref.indices[:, :100])}
                del q, ref
        else:
            spec = cell.in_shardings[1]["dense"][:1]
            rec["logits"] = (gather_block(res, spec, mesh) if mesh.size > 1
                             else res).cpu()
        out[s] = rec
        if mesh.size == 1 or mesh.rank == 0:
            print(f"phase 13: {'one rank' if mesh.size == 1 else 'rank 0'} "
                  f"dcn-v2/{s}: call ms {[round(x, 2) for x in ms]}",
                  flush=True)
        del b, c, cand, args, res
    # float32 train_batch at its own batch: a cold and a warm step
    cell = cells["train_batch"]
    rc = steps.recsys_cell(RECSYS_ARCH, "train_batch", smoke=PHASE13_SMOKE,
                           dims=dict(batch=PHASE13_TRAIN_B))
    model.requires_grad_(True)
    opt = adamw_init(steps.params_dict(model), steps.RECSYS_ADAMW)
    res, ms = [], []
    mesh.wire.reset()
    for i in range(2):
        b, _ = steps.recsys_rank_batch(cell, mesh,
                                       steps.recsys_batch(rc, i, seed=14))
        (_, opt, loss, gnorm), t = _timed(lambda: cell.fn(model, opt, b),
                                          dev)
        res.append((float(loss), float(gnorm)))
        ms.append(t)
    wire = _wire13(mesh)
    sched = steps.recsys_collective_schedule(cell, mesh.shape)
    want = {a: {k: [2 * x, 2 * y] for k, (x, y) in d.items()}
            for a, d in sched.items()}
    out["train_batch"] = {"steps": res, "step_ms": ms, "wire": wire,
                          "schedule_equal": wire["by_axis"] == want,
                          "batch": PHASE13_TRAIN_B}
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    # one float64 step on a copy, held leaf by leaf
    cell = cells["check"]
    rc = steps.recsys_cell(RECSYS_ARCH, "train_batch", smoke=PHASE13_SMOKE,
                           dims=dict(batch=PHASE13_CHECK_B))
    batch = steps.recsys_batch(rc, seed=12)
    # from the seed's weights again, cut, then in float64 (the float32
    # blocks go: four ranks share the card)
    m64 = dcn.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)[0]
    steps.shard_recsys(cell, m64, mesh)
    m64 = m64.double().requires_grad_(True)
    opt = adamw_init(steps.params_dict(m64), steps.RECSYS_ADAMW)
    b, _ = steps.recsys_rank_batch(cell, mesh, batch)
    mesh.wire.reset()
    (_, opt, loss, gnorm), t = _timed(lambda: cell.fn(m64, opt, b), dev)
    wire = _wire13(mesh)
    sched = steps.recsys_collective_schedule(cell, mesh.shape, el=8)
    rows = torch.from_numpy(_dcn_touched(cfg, batch)).to(dev)
    tb = m64.embed.table
    lo = (mesh.coord("model") if "model" in part_axes(
        m64.shard_specs["embed.table"][0]) else 0) * tb.shape[0]
    mine = rows[(rows >= lo) & (rows < lo + tb.shape[0])] - lo
    untouched = torch.ones(tb.shape[0], dtype=torch.bool, device=dev)
    untouched[mine] = False
    check = {"loss": float(loss), "grad_norm": float(gnorm), "ms": t,
             "wire": wire, "schedule_equal": wire["by_axis"] == sched,
             "table_rows": (mine + lo).cpu(),
             "table": {"params": tb.detach()[mine].cpu(),
                       "mu": opt.mu["embed.table"][mine].cpu(),
                       "nu": opt.nu["embed.table"][mine].cpu()},
             "untouched_moments_zero": bool(
                 (opt.mu["embed.table"][untouched] == 0).all()
                 and (opt.nu["embed.table"][untouched] == 0).all())}
    small = {k: k != "embed.table" for k in dict(m64.named_parameters())}
    st = {}
    for part, src in (("params", dict(m64.named_parameters())),
                      ("mu", opt.mu), ("nu", opt.nu)):
        st[part] = {k: (gather_block(v.detach(), m64.shard_specs[k], mesh)
                        if mesh.size > 1 else v.detach()).cpu()
                    for k, v in src.items() if small[k]}
    check["state"] = st
    out["check"] = check
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del m64, opt, b
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase13_rank(rank: int, world: int, batches: dict, device: str) -> dict:
    """One of four gloo ranks sharing the card: the GNN cases and DCN-v2
    on the ``(2, 2)`` mesh (``phase13_gnn_run``, ``phase13_dcn_run``),
    and the four kernels' launch counters (which must stay 0)."""
    from repro_torch.kernels.binned_pull import binned_pull as bp_mod
    from repro_torch.kernels.block_spmm import block_spmm as bs_mod
    from repro_torch.kernels.flash_attention import flash_attention as fa_mod
    from repro_torch.kernels.msbfs_extend import msbfs_extend as mx_mod
    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    mesh = make_mesh(PHASE13_MESH, ("data", "model"), dev)
    out = {"rank": rank, "coords": {a: mesh.coord(a)
                                    for a in mesh.axis_names}}
    with phase13_depth():
        out["gnn"] = phase13_gnn_run(mesh, batches, dev)
    out["dcn"] = phase13_dcn_run(mesh, dev)
    out["launches"] = {k: f.launches for k, f in (
        ("binned_pull", bp_mod.fused_binned_pull),
        ("msbfs_extend", mx_mod.msbfs_extend_blocks),
        ("block_spmm", bs_mod.block_spmm),
        ("flash_attention", fa_mod.flash_attention))}
    # numpy across the process boundary: a tensor would travel as shared
    # memory that dies with the rank
    return _tree_map(out, torch.Tensor, lambda t: t.numpy())


def _tree_map(tree, kind, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, kind, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, str):
        return type(tree)(_tree_map(v, kind, fn) for v in tree)
    return fn(tree) if isinstance(tree, kind) else tree


def _leaf_check(got: dict, exp: dict, tol, lr, steps_run, exact, what,
                bad: list) -> dict:
    """Per leaf: moments within ``tol`` (rtol plus a share of the leaf's
    largest), parameters within GNN_PARAM_ABS (``exact``) or within 0.1
    lr but for one entry or 1% and all within 2 lr a step; returns each
    leaf's worst moment share and parameter difference."""
    rep = {}
    for k in exp["params"]:
        shares = []
        for m in ("mu", "nu"):
            e, g = exp[m][k].double(), got[m][k].double()
            scale = max(float(e.abs().max()), 1e-30)
            d = (g - e).abs()
            shares.append(float(d.max()) / scale)
            if (d > tol[0] * e.abs() + tol[1] * scale).any() or \
                    not bool(torch.isfinite(g).all()):
                bad.append(f"{what} {m} {k} ({shares[-1]:.3g} of its "
                           "largest)")
        d = (got["params"][k].double() - exp["params"][k].double()).abs()
        if exact:
            ok = bool((d <= GNN_PARAM_ABS).all())
        else:
            ok = bool((d <= 2 * lr * steps_run).all()) and int(
                (d > 0.1 * lr).sum()) <= max(1, 0.01 * d.numel())
        if not ok:
            bad.append(f"{what} parameter {k} ({float(d.max()):.3g})")
        rep[k] = {"moment_share": shares, "param_max_abs": float(d.max())}
    return rep


def _wire_summary(reps, get) -> dict:
    """The ranks' collectives for one cell: the slowest rank's ms, rank
    0's records by axis and kind, payload and staged bytes."""
    w0 = get(reps[0])
    return {"ms_max": max(get(r)["ms"] for r in reps),
            "ms_by_kind": w0["ms_by_kind"], "by_axis": w0["by_axis"],
            "payload_bytes": w0["payload_bytes"],
            "staged_bytes": w0["staged_bytes"],
            "staged_by_kind": w0["staged_by_kind"]}


def phase_13(dev, csr, launches_before) -> dict:
    """The GNN and recsys cells (``launch/steps.py``'s ``_gnn_cell`` and
    ``_recsys_cell`` on a ``Mesh``) on a ``(2, 2)`` mesh of four gloo
    ranks sharing the card, against the one-rank cells on the card from
    the same seeded weights and batches (the steps in the module
    docstring)."""
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh, run_ranks

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated(dev) / 1e9  # earlier phases'
    batches = phase13_gnn_batches(dev, csr)
    one_mesh = make_mesh((1, 1), ("data", "model"), dev)
    with phase13_depth():
        one_gnn = phase13_gnn_run(one_mesh, batches, dev)
    one_dcn = phase13_dcn_run(one_mesh, dev)
    one_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    # the ranks' caching allocators grow in place (four share the card)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    reps = run_ranks(phase13_rank, RANKS, (batches, f"{DEVICE}:0"),
                     backend="gloo", timeout_s=PHASE13_TIMEOUT_S,
                     threads=RANK_THREADS)
    reps = [_tree_map(r, np.ndarray, torch.from_numpy) for r in reps]
    ranks_s = time.perf_counter() - t1
    lr = steps.GNN_ADAMW.lr
    bad, cells = [], {}
    for r in reps:
        if any(r["launches"].values()):
            bad.append(f"rank {r['rank']} launched {r['launches']}")
        for case, rec in r["gnn"].items():
            if not (rec["schedule_equal"] and rec["blocks_ok"]):
                bad.append(f"rank {r['rank']} {case}: schedule "
                           f"{rec['schedule_equal']}, blocks "
                           f"{rec['blocks_ok']}")
        d = r["dcn"]
        if not d["blocks_ok"]:
            bad.append(f"rank {r['rank']} dcn-v2 blocks")
        for s in ("serve_p99", "serve_bulk", "retrieval_cand", "check",
                  "train_batch"):
            if not d[s]["schedule_equal"]:
                bad.append(f"rank {r['rank']} dcn-v2 {s} schedule")
        if not d["check"]["untouched_moments_zero"]:
            bad.append(f"rank {r['rank']} dcn-v2 table rows off the batch "
                       "moved")
    # 13a: each GNN case against one rank
    for arch, shape, dtype in PHASE13_GNN:
        case = f"{arch}/{shape}"
        one, mesh0 = one_gnn[case], reps[0]["gnn"][case]
        exact = dtype == torch.float64
        tol = GNN_F64_TOL if exact else GNN_GRAD_TOL
        for i, ((ml, mn), (ol, on)) in enumerate(zip(mesh0["steps"],
                                                     one["steps"])):
            if not (abs(ml - ol) <= (tol if exact else GNN_TOL)[0] * abs(ol)
                    and abs(mn - on) <= tol[0] * abs(on)
                    and np.isfinite(ml) and np.isfinite(mn)):
                bad.append(f"{case} step {i}: mesh loss {ml} norm {mn}, "
                           f"one rank {ol} {on}")
        leaves = _leaf_check(mesh0["state"], one["state"], tol, lr,
                             PHASE13_STEPS, exact, case, bad)
        worst = max(leaves.items(), key=lambda kv: max(kv[1]["moment_share"]))
        step_ms = [max(r["gnn"][case]["step_ms"][i] for r in reps)
                   for i in range(PHASE13_STEPS)]
        cells[case] = {
            "dtype": mesh0["dtype"], "notes": mesh0["notes"],
            "step_ms": step_ms, "one_rank_step_ms": one["step_ms"],
            "losses": [x[0] for x in mesh0["steps"]],
            "one_rank_losses": [x[0] for x in one["steps"]],
            "grad_norms": [x[1] for x in mesh0["steps"]],
            "worst_moment_leaf": {worst[0]: worst[1]},
            "param_max_abs": max(v["param_max_abs"]
                                 for v in leaves.values()),
            "tol": tol,
            "collectives": _wire_summary(reps, lambda r: r["gnn"][case][
                "wire"]),
            "peak_gb": max(r["gnn"][case]["peak_gb"] for r in reps),
            "one_rank_peak_gb": one["peak_gb"],
            "layout": mesh0["layout"]}
    # 13b: DCN-v2 against one rank
    d0 = reps[0]["dcn"]
    for s in ("serve_p99", "serve_bulk"):
        ok, err = _gnn_close(d0[s]["logits"], one_dcn[s]["logits"],
                             RECSYS_TOL)
        if not ok or not bool(torch.isfinite(d0[s]["logits"]).all()):
            bad.append(f"dcn-v2 {s} logits off by {err}")
        cells[f"dcn-v2/{s}"] = {
            "batch": d0[s]["batch"], "logits_max_abs": err,
            "call_ms_p50": float(np.median([max(r["dcn"][s]["call_ms"][i]
                                                for r in reps)
                                            for i in range(
                                                PHASE13_CALLS[s])])),
            "one_rank_call_ms_p50": float(np.median(one_dcn[s]["call_ms"])),
            "collectives": _wire_summary(reps, lambda r: r["dcn"][s]["wire"])}
    # the top 100 against a float64 sort of the one-rank query's scores
    rv, ri = d0["retrieval_cand"]["values"], d0["retrieval_cand"]["indices"]
    ov, oi = one_dcn["retrieval_cand"]["values"], \
        one_dcn["retrieval_cand"]["indices"]
    ok_v, err_v = _gnn_close(rv, ov, RECSYS_TOL)
    if not ok_v or not _distinct_equal(ri, ov, oi):
        bad.append(f"dcn-v2 retrieval top 100 against one rank ({err_v})")
    cells["dcn-v2/retrieval_cand"] = {
        "top_k_max_abs": err_v,
        "indices_equal": bool(torch.equal(ri, oi)),
        "float64_sort": one_dcn["retrieval_cand"].get("float64_sort"),
        "call_ms_p50": float(np.median([max(r["dcn"]["retrieval_cand"][
            "call_ms"][i] for r in reps) for i in range(
                PHASE13_CALLS["retrieval_cand"])])),
        "one_rank_call_ms_p50": float(np.median(
            one_dcn["retrieval_cand"]["call_ms"])),
        "collectives": _wire_summary(reps, lambda r: r["dcn"][
            "retrieval_cand"]["wire"])}
    f64 = one_dcn["retrieval_cand"]["float64_sort"]
    if not (f64["values_ok"] and f64["indices_equal_where_distinct"]):
        bad.append(f"dcn-v2 retrieval on one rank against a float64 sort: "
                   f"{f64}")
    # the float64 step, leaf by leaf (the table by its touched rows, each
    # row block once: from the ranks at data coordinate 0)
    oc = one_dcn["check"]
    mc = [r["dcn"]["check"] for r in reps if r["coords"]["data"] == 0]
    for name, key in (("loss", "loss"), ("grad_norm", "grad_norm")):
        if not abs(mc[0][key] - oc[key]) <= RECSYS_F64_TOL[0] * abs(oc[key]):
            bad.append(f"dcn-v2 float64 {name} {mc[0][key]} against "
                       f"{oc[key]}")
    leaves = _leaf_check(mc[0]["state"], oc["state"], RECSYS_F64_TOL, lr,
                         1, True, "dcn-v2 float64", bad)
    rows = torch.cat([m["table_rows"] for m in mc])
    order = torch.argsort(rows)
    got_t = {k: torch.cat([m["table"][k] for m in mc])[order]
             for k in ("params", "mu", "nu")}
    if not torch.equal(rows[order], oc["table_rows"]):
        bad.append("dcn-v2 float64: the ranks' touched rows are not the "
                   "batch's")
    else:
        leaves["embed.table (touched rows)"] = _leaf_check(
            {k: {"t": v} for k, v in got_t.items()},
            {k: {"t": oc["table"][k]} for k in ("params", "mu", "nu")},
            RECSYS_F64_TOL, lr, 1, True, "dcn-v2 float64 table", bad)["t"]
    cells["dcn-v2/train_batch"] = {
        "float64_check": {"batch": PHASE13_CHECK_B, "loss": mc[0]["loss"],
                          "one_rank_loss": oc["loss"],
                          "grad_norm": mc[0]["grad_norm"],
                          "one_rank_grad_norm": oc["grad_norm"],
                          "touched_rows": int(rows.numel()),
                          "worst_moment_share": max(
                              max(v["moment_share"]) for v in
                              leaves.values()),
                          "ms": max(r["dcn"]["check"]["ms"]
                                    for r in reps),
                          "one_rank_ms": oc["ms"]},
        "batch": PHASE13_TRAIN_B,
        "step_ms": [max(r["dcn"]["train_batch"]["step_ms"][i] for r in reps)
                    for i in range(2)],
        "one_rank_step_ms": one_dcn["train_batch"]["step_ms"],
        "losses": [x[0] for x in d0["train_batch"]["steps"]],
        "one_rank_losses": [x[0] for x in one_dcn["train_batch"]["steps"]],
        "collectives": _wire_summary(reps, lambda r: r["dcn"][
            "train_batch"]["wire"]),
        "peak_gb": max(r["dcn"]["peak_gb"] for r in reps),
        "one_rank_peak_gb": one_dcn["peak_gb"]}
    for (ml, mn), (ol, on) in zip(d0["train_batch"]["steps"],
                                  one_dcn["train_batch"]["steps"]):
        if not (abs(ml - ol) <= RECSYS_TOL[0] * abs(ol) + RECSYS_TOL[1]
                and abs(mn - on) <= GNN_GRAD_TOL[0] * abs(on)
                and np.isfinite(ml)):
            bad.append(f"dcn-v2 float32 train_batch: mesh {ml} {mn}, one "
                       f"rank {ol} {on}")
    launched = launches_before()
    if any(launched.values()):
        bad.append(f"phase 13 launched a port kernel: {launched}")
    if bad:
        fail(f"phase 13: {bad[:10]}")
    out = {"mesh": list(PHASE13_MESH), "ranks": RANKS, "cells": cells,
           "n_layers": PHASE13_LAYERS,
           "kernel_launches": launched, "held_before_gb": held_gb,
           "device": torch.cuda.get_device_name(dev),
           "one_rank_s": one_s, "ranks_s": ranks_s,
           "seconds": time.perf_counter() - t0}
    for case, c in cells.items():
        print(f"phase 13: {case}: " + json.dumps(c), flush=True)
    return out


# -- phase 14: LM training on a mesh of ranks ----------------------------------

PHASE14_MESH = (2, 2)  # ("data", "model"): 4 gloo ranks sharing the card
#: MiniCPM-2B's 40 layers cut to 1 at full width, so that the whole run
#: stays inside its time limit with phase 15 (PERF.md names the cut)
PHASE14_LAYERS = 1
PHASE14_TIMED = 2  # warm bfloat16 steps after a cold one
PHASE14_TIMEOUT_S = 600  # the rank group, or it fails
PHASE14_SEED = 14  # the batch's tokens
#: the float32 check step, mesh against one rank's ``make_train_step``
#: (TF32 off; the ranks' sums, cuBLAS's tiling of one row against two and
#: the split log-sum-exp round in other orders): the loss and the
#: gradient norm at rtol 1e-5, each moment leaf within 1e-4 of its
#: largest magnitude, the parameters within ``TRAIN_PARAM_ABS`` for all
#: but ``TRAIN_PARAM_LOOSE`` of them and within 0.1 lr, except where the
#: step's gradient is rounding-sized (below 1e-6 of its leaf's largest:
#: a first AdamW step moves by ``lr g / (|g| + 1e-8)``), there within
#: 2 lr
PHASE14_TOL = {"loss": 1e-5, "grad_norm": 1e-5, "moment": 1e-4,
               "rounding": 1e-6}
PHASE14_REF = "phase14_ref"  # the one-rank state, under build/, removed
#: the float32 (2, 2) state's elastic checkpoint, under build/, removed;
#: it restores onto this mesh of the same four ranks and onto one rank
PHASE14_CKPT = "phase14_ckpt"
PHASE14_RESIZE = (1, 4)
#: words one int64 sum of ``bits_digest`` adds: 2^22 words below 2^31
#: times weights of at most 251 stay below 2^63
DIGEST_CHUNK = 1 << 22


def phase14_cell(mesh, dtype):
    """``train_4k`` of MiniCPM-2B at full width cut to ``PHASE14_LAYERS``
    layers and ``TRAIN_BATCH`` (phases 8c and 8b's cuts), in ``dtype``."""
    from repro_torch.configs import base
    from repro_torch.launch import steps

    spec = base.get(LM_ARCH)
    cfg = dataclasses.replace(spec.full_config(), n_layers=PHASE14_LAYERS,
                              dtype=dtype)
    spec = dataclasses.replace(spec, full_config=lambda: cfg)
    b, s = TRAIN_BATCH
    shape = next(x for x in spec.shapes if x.name == "train_4k")
    shape = dataclasses.replace(shape, dims=dict(seq_len=s, global_batch=b))
    return steps._lm_cell(spec, shape, mesh, False)


def phase14_schedule(cell, mesh_shape: dict, specs: dict,
                     shapes: dict) -> dict:
    """``collective_schedule(kind="train")`` of one step of ``cell``,
    by kind and group (``Wire.by_kind``'s form)."""
    from repro_torch.models import transformer_mesh as tmesh
    from repro_torch.nn.module import sharding_rules

    cfg = cell.config
    n_micro = cell.decisions["n_micro"]
    rows = cell.dims["global_batch"] // mesh_shape["data"] // n_micro
    sch = tmesh.collective_schedule(
        cfg, "train", rows, cell.dims["seq_len"], mesh_shape,
        sharding_rules(False, True), specs, shapes, n_micro=n_micro)
    return tmesh.merge_records(sch["global"], *sch["layers"], sch["final"])


def _phase14_model(cfg, dev):
    """``cfg``'s model from seed 0 on ``dev`` (the same weights on every
    rank and on one rank)."""
    from repro_torch.models import transformer as tfm

    return tfm.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def bits_digest(t: torch.Tensor) -> list:
    """A fingerprint of a tensor's bits, computed where it lies: its
    shape, dtype and two integer sums of its 32-, 16- or 8-bit words,
    plain and weighted by position (mod 251, plus 1), exact in any
    order. Two tensors with the same bits have the same digest; a
    restore that misplaces, drops or rounds a value changes it."""
    words = t.detach().contiguous().reshape(-1)
    words = words.view({4: torch.int32, 2: torch.int16,
                        1: torch.int8}[words.element_size()])
    total = weighted = 0
    for i in range(0, words.numel(), DIGEST_CHUNK):
        c = words[i:i + DIGEST_CHUNK].long()
        w = torch.arange(i, i + c.numel(), device=c.device) % 251 + 1
        total += int(c.sum())
        weighted += int((c * w).sum())
    return [list(t.shape), str(t.dtype), total, weighted]


def state_digests(tree, specs=None, mesh_shape=None, coords=None) -> dict:
    """``{leaf key: bits_digest}`` of a checkpoint tree's tensors (a
    ``Stacked`` leaf's groups as ``key#g``); with ``specs`` (by leaf
    key), of each leaf's block under its spec at ``coords``."""
    from repro_torch.checkpoint.checkpoint import Stacked, _flatten_with_paths
    from repro_torch.nn.module import block_slices

    out = {}
    for key, leaf in _flatten_with_paths(tree).items():
        spec = None if specs is None else specs[key]
        parts = (list(enumerate(leaf.tensors)) if isinstance(leaf, Stacked)
                 else [(None, leaf)])
        for g, t in parts:
            if spec is not None:
                sp = spec if g is None else spec[1:]
                t = t[block_slices(t.shape, sp, mesh_shape, coords)]
            out[key if g is None else f"{key}#{g}"] = bits_digest(t)
    return out


def phase14_elastic(mesh, cell, model, opt, gbatch, ref_dir: str,
                    ckpt_dir: str, dev) -> dict:
    """The elastic checkpoint on this rank, after the float32 check
    step: the (2, 2) state saved (rank 0 writes), restored onto a
    ``PHASE14_RESIZE`` mesh of the same ranks, one more float32 step on
    each mesh, the two held against each other leaf by leaf. Returns
    each mesh's leaf digests and specs, the steps' loss, norm and ms,
    the check's spreads, the seconds and the peak memory."""
    import shutil

    import torch.distributed as dist

    from repro_torch.checkpoint.checkpoint import (CheckpointManager,
                                                   _flatten_with_paths)
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.core.collectives import max_allreduce
    from repro_torch.nn.module import reshard_block
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    t_all = time.perf_counter()
    dist.barrier()  # every rank has read the one-rank reference
    if mesh.rank == 0:  # so that one copy of the state is on disk at most
        shutil.rmtree(ref_dir, ignore_errors=True)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    dist.barrier()
    torch.cuda.reset_peak_memory_stats(dev)
    rec = {}

    def specs_of(shardings):
        return {k: s.spec for k, s in _flatten_with_paths(shardings).items()}

    sh22 = steps.state_shardings(model, mesh)
    state = steps.train_state(model, opt)
    rec["digests"] = {"22": state_digests(state)}
    rec["specs"] = {"22": specs_of(sh22)}
    rec["coords"] = {"22": {a: mesh.coord(a) for a in mesh.axis_names}}
    mesh.wire.reset()
    mgr = CheckpointManager(ckpt_dir, keep=1)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    mgr.save(1, state, shardings=sh22)
    rec["gather_s"] = time.perf_counter() - t0
    rec["gather_wire"] = _wire13(mesh)
    rec["host_rss_gb_after_gather"] = host_rss_gb()
    t0 = time.perf_counter()
    mgr.wait()
    rec["write_s"] = time.perf_counter() - t0
    del state
    # restore onto PHASE14_RESIZE over the same ranks
    mesh14 = make_mesh(PHASE14_RESIZE, ("data", "model"), dev)
    cell14 = phase14_cell(mesh14, torch.float32)
    model14 = _phase14_model(cell14.config, dev)
    steps.shard_lm(cell14, model14, mesh14)
    model14.requires_grad_(True)
    opt14 = adamw_init(steps.params_dict(model14), AdamWConfig(
        moment_dtype=steps._moment_dtype(cell14.config)))
    sh14 = steps.state_shardings(model14, mesh14)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    _, rec["restored_step"] = CheckpointManager(ckpt_dir).restore(
        steps.train_state(model14, opt14), shardings=sh14)
    torch.cuda.synchronize(dev)
    rec["restore_s"] = time.perf_counter() - t0
    rec["digests"]["14"] = state_digests(steps.train_state(model14, opt14))
    rec["specs"]["14"] = specs_of(sh14)
    rec["coords"]["14"] = {a: mesh14.coord(a) for a in mesh14.axis_names}
    # one more float32 step on each mesh, from the same state
    runs = {}
    for key, c, m, o, msh in (("14", cell14, model14, opt14, mesh14),
                              ("22", cell, model, opt, mesh)):
        (_, o, loss, gnorm), ms = _timed(lambda: c.fn(m, o, gbatch), dev)
        runs[key] = {"ms": ms, "loss": float(loss),
                     "grad_norm": float(gnorm)}
        if key == "14":
            opt14 = o
        else:
            opt = o
    rec["steps"] = runs
    # the (2, 2) blocks against the same blocks of the (1, 4) state,
    # leaf by leaf, each rank receiving its (2, 2) block's part of the
    # (1, 4) state on the wire device
    lr, specs22, specs14 = 3e-4, model.shard_specs, model14.shard_specs
    p22 = dict(model.named_parameters())
    p14 = dict(model14.named_parameters())
    every = mesh.axes(mesh.axis_names)
    share = {"mu": 0.0, "nu": 0.0}
    n = loose = over = 0
    p_max = 0.0
    t0 = time.perf_counter()
    with torch.no_grad():
        for name in specs22:
            ref, top = {}, {}
            for part, t in (("params", p14[name]), ("mu", opt14.mu[name]),
                            ("nu", opt14.nu[name])):
                ref[part] = reshard_block(
                    t.detach().to(mesh14.wire_device), specs14[name],
                    mesh14, specs22[name], mesh).to(dev)
                top[part] = float(max_allreduce(
                    ref[part].abs().max().reshape(1).to(mesh.wire_device),
                    every)[0])
            for part in ("mu", "nu"):
                e = float((getattr(opt, part)[name] - ref[part]).abs().max())
                share[part] = max(share[part], e / max(top[part], 1e-30))
            d = (p22[name].detach() - ref["params"]).abs()
            tiny = ref["mu"].abs() <= PHASE14_TOL["rounding"] * top["mu"]
            p_max = max(p_max, float(d.max()))
            over += (int(((d > 0.1 * lr) & ~tiny).sum())
                     + int((d > 2 * lr).sum()))
            n += d.numel()
            loose += int((d > TRAIN_PARAM_ABS).sum())
            del ref, d, tiny
    rec["compare_s"] = time.perf_counter() - t0
    rec["check"] = {"moment_share": share, "param_max_abs": p_max,
                    "param_over": over, "param_loose": loose, "param_n": n}
    rec["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del model14, opt14
    dist.barrier()
    rec["seconds"] = time.perf_counter() - t_all
    return rec


def phase14_rank(rank: int, world: int, batch: dict, ref_dir: str,
                 ckpt_dir: str, device: str) -> dict:
    """One of four gloo ranks sharing the card: the cell's model (seed 0,
    as the one-rank run) cut by ``steps.shard_lm``; a cold and
    ``PHASE14_TIMED`` warm bfloat16 steps on the global ``batch``, then
    a float32 step from fresh weights held, block by block, against the
    one-rank state under ``ref_dir``; then the elastic checkpoint under
    ``ckpt_dir`` (``phase14_elastic``). Returns each step's ms, loss,
    norm and collectives (equal to the schedule or not), peak memory,
    kernel launches, the check's spreads and the elastic record."""
    from repro_torch.kernels.binned_pull import binned_pull as bp_mod
    from repro_torch.kernels.block_spmm import block_spmm as bs_mod
    from repro_torch.kernels.flash_attention import flash_attention as fa_mod
    from repro_torch.kernels.msbfs_extend import msbfs_extend as mx_mod
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.nn import attention as attn
    from repro_torch.nn.module import block_of
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    counters = {"binned_pull": bp_mod.fused_binned_pull,
                "msbfs_extend": mx_mod.msbfs_extend_blocks,
                "block_spmm": bs_mod.block_spmm,
                "flash_attention": fa_mod.flash_attention}
    for f in counters.values():
        f.launches = 0
    attn.route_calls.update(dict.fromkeys(attn.route_calls, 0))
    mesh = make_mesh(PHASE14_MESH, ("data", "model"), dev)
    gbatch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    out = {"rank": rank, "coords": {a: mesh.coord(a)
                                    for a in mesh.axis_names}, "runs": {}}

    def run(dtype, n_steps):
        cell = phase14_cell(mesh, dtype)
        model = _phase14_model(cell.config, dev)
        shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
        steps.shard_lm(cell, model, mesh)
        model.requires_grad_(True)
        opt = adamw_init(steps.params_dict(model), AdamWConfig(
            moment_dtype=steps._moment_dtype(cell.config)))
        want = phase14_schedule(cell, mesh.shape, model.shard_specs, shapes)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        rec = {"steps": []}
        for _ in range(n_steps):
            mesh.wire.reset()
            (_, opt, loss, gnorm), ms = _timed(
                lambda: cell.fn(model, opt, gbatch), dev)
            w = _wire13(mesh)
            w["by_kind"] = {k: {int(g): list(v) for g, v in d.items()}
                            for k, d in mesh.wire.by_kind.items()}
            rec["steps"].append({"ms": ms, "loss": float(loss),
                                 "grad_norm": float(gnorm), "wire": w,
                                 "schedule_equal": w["by_kind"] == want})
        rec["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        rec["notes"] = cell.notes
        rec["remat"] = cell.decisions["remat"]
        return rec, model, opt, cell

    rec, model, opt, _ = run(torch.bfloat16, 1 + PHASE14_TIMED)
    out["runs"]["bfloat16"] = rec
    del model, opt
    rec, model, opt, cell = run(torch.float32, 1)
    out["runs"]["float32"] = rec
    # the check: each block against its slice of the one-rank state
    with open(os.path.join(ref_dir, "max.json")) as f:
        top = json.load(f)
    lr, specs = 3e-4, model.shard_specs
    mine = {"params": {k: p.detach() for k, p in model.named_parameters()},
            "mu": opt.mu, "nu": opt.nu}
    share = {"mu": 0.0, "nu": 0.0}
    worst = {}
    n = loose = over = tiny_n = 0
    p_max = 0.0
    for name, spec in specs.items():
        ref = {part: torch.from_numpy(np.array(block_of(
            np.load(os.path.join(ref_dir, f"{part}.{name}.npy"),
                    mmap_mode="r"), spec, mesh))).to(dev)
            for part in mine}
        for part in ("mu", "nu"):
            e = float((mine[part][name].float() - ref[part]).abs().max())
            e /= max(top[part][name], 1e-30)
            worst[f"{part} {name}"] = e
            share[part] = max(share[part], e)
        d = (mine["params"][name].float() - ref["params"]).abs()
        tiny = ref["mu"].abs() <= PHASE14_TOL["rounding"] * top["mu"][name]
        p_max = max(p_max, float(d.max()))
        over += int(((d > 0.1 * lr) & ~tiny).sum()) + int((d > 2 * lr).sum())
        tiny_n += int(tiny.sum())
        n += d.numel()
        loose += int((d > TRAIN_PARAM_ABS).sum())
        del ref, d, tiny
    out["check"] = {"moment_share": share, "param_max_abs": p_max,
                    "param_over": over, "param_loose": loose,
                    "param_n": n, "tiny_gradients": tiny_n,
                    "worst_leaf": max(worst.items(), key=lambda kv: kv[1])}
    out["elastic"] = phase14_elastic(mesh, cell, model, opt, gbatch,
                                     ref_dir, ckpt_dir, dev)
    out["launches"] = {k: f.launches for k, f in counters.items()}
    out["route_calls"] = dict(attn.route_calls)
    return out


def phase14_scale_down(dev, ckpt_dir: Path, reps: list) -> dict:
    """The main process's part of the elastic checkpoint: the (2, 2)
    state's checkpoint restored into a one-rank float32 model on the
    card, every rank's (2, 2) and ``PHASE14_RESIZE`` block digests held
    against the same blocks of it (so the file is the gathered state
    and each restore ``block_of`` it, bit for bit), and each rank's
    step on both meshes against ``PHASE14_TOL``. Returns the figures
    and the faults found (``bad``)."""
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    t_all = time.perf_counter()
    bad = []
    cfg = phase14_cell(make_mesh((1, 1), ("data", "model"), dev),
                       torch.float32).config
    model = _phase14_model(cfg, dev)
    opt = adamw_init(dict(model.named_parameters()), AdamWConfig(
        moment_dtype=steps._moment_dtype(cfg)))
    nbytes = sum(f.stat().st_size for f in (ckpt_dir / "step_1").iterdir())
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    tree = tfm.state_tree(model, opt)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    _, step = CheckpointManager(str(ckpt_dir)).restore(tree)
    torch.cuda.synchronize(dev)
    restore_s = time.perf_counter() - t0
    if step != 1:
        bad.append(f"the one-rank restore read step {step}, not 1")
    t0 = time.perf_counter()
    for r in reps:
        e = r["elastic"]
        if e["restored_step"] != 1:
            bad.append(f"rank {r['rank']} restored step "
                       f"{e['restored_step']}, not 1")
        for key, shape in (("22", PHASE14_MESH), ("14", PHASE14_RESIZE)):
            want = state_digests(tree, e["specs"][key],
                                 dict(zip(("data", "model"), shape)),
                                 e["coords"][key])
            off = [k for k in want if want[k] != e["digests"][key].get(k)]
            if off or set(want) != set(e["digests"][key]):
                bad.append(f"rank {r['rank']} {shape} blocks are not the "
                           f"one-rank restore's at {off[:5]}")
        s14, s22 = e["steps"]["14"], e["steps"]["22"]
        for k in ("loss", "grad_norm"):
            if not abs(s14[k] - s22[k]) <= PHASE14_TOL[k] * abs(s22[k]):
                bad.append(f"rank {r['rank']} {k} {s14[k]} on "
                           f"{PHASE14_RESIZE} against {s22[k]} on "
                           f"{PHASE14_MESH}")
        c = e["check"]
        if (max(c["moment_share"].values()) > PHASE14_TOL["moment"]
                or c["param_over"]
                or c["param_loose"] > TRAIN_PARAM_LOOSE * c["param_n"]):
            bad.append(f"rank {r['rank']} state after the step on "
                       f"{PHASE14_RESIZE} against {PHASE14_MESH}: {c}")
    digest_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    del model, opt, tree
    gc.collect()
    torch.cuda.empty_cache()
    main_s = time.perf_counter() - t_all
    per = [{k: r["elastic"][k] for k in (
        "gather_s", "write_s", "restore_s", "compare_s", "seconds",
        "peak_gb", "steps", "check", "host_rss_gb_after_gather")}
        | {"rank": r["rank"],
           "gather_payload_gb": r["elastic"]["gather_wire"]["payload_bytes"]
           / 1e9} for r in reps]
    return {"bytes": nbytes, "resize": list(PHASE14_RESIZE),
            "ranks": per, "one_rank_restore_s": restore_s,
            "digest_check_s": digest_s, "one_rank_peak_gb": peak,
            "main_s": main_s,
            "added_s": max(p["seconds"] for p in per) + main_s,
            "card": card_line(), "bad": bad}


def phase_14(dev, launches_before) -> dict:
    """MiniCPM-2B's ``train_4k`` cell (``launch/steps.py``'s LM train step
    on a ``Mesh``, ``models/transformer_mesh.py``'s ``loss_fn``) on a
    ``(2, 2)`` mesh of four gloo ranks sharing the card, against one
    rank's ``launch/train.py::make_train_step`` on the card from the
    same seeded weights and batch (the steps in the module
    docstring)."""
    import shutil

    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh, run_ranks
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    b, s = TRAIN_BATCH
    one_mesh = make_mesh((1, 1), ("data", "model"), dev)
    cfg16 = phase14_cell(one_mesh, torch.bfloat16).config
    toks = np.random.default_rng(PHASE14_SEED).integers(
        0, cfg16.vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    dbatch = train.device_batch(batch, dev)
    ocfg = AdamWConfig(lr=3e-4)
    one = {}
    ref_dir = ROOT / "build" / PHASE14_REF
    shutil.rmtree(ref_dir, ignore_errors=True)
    ref_dir.mkdir(parents=True)
    for dtype, n_steps in ((torch.bfloat16, 1 + PHASE14_TIMED),
                           (torch.float32, 1)):
        cfg = phase14_cell(one_mesh, dtype).config
        step = train.make_train_step(cfg, ocfg)
        model = _phase14_model(cfg, dev)
        model.requires_grad_(True)
        opt = adamw_init(dict(model.named_parameters()), ocfg)
        torch.cuda.reset_peak_memory_stats(dev)
        runs = []
        for _ in range(n_steps):
            (_, opt, loss, gnorm), ms = _timed(
                lambda: step(model, opt, dbatch, 1.0), dev)
            runs.append({"ms": ms, "loss": float(loss),
                         "grad_norm": float(gnorm)})
        one[str(dtype).split(".")[-1]] = {
            "steps": runs,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        if dtype == torch.float32:  # the reference state, leaf by leaf
            top = {"mu": {}, "nu": {}}
            for part, tree in (("params", dict(model.named_parameters())),
                               ("mu", opt.mu), ("nu", opt.nu)):
                for name, t in tree.items():
                    t = t.detach()
                    if part != "params":
                        top[part][name] = float(t.abs().max())
                    np.save(ref_dir / f"{part}.{name}.npy", t.cpu().numpy())
            (ref_dir / "max.json").write_text(json.dumps(top))
        del model, opt, step
        gc.collect()
        torch.cuda.empty_cache()
    del dbatch
    one_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    ckpt_dir = ROOT / "build" / PHASE14_CKPT
    try:
        reps = run_ranks(phase14_rank, RANKS,
                         (batch, str(ref_dir), str(ckpt_dir), f"{DEVICE}:0"),
                         backend="gloo", timeout_s=PHASE14_TIMEOUT_S,
                         threads=RANK_THREADS)
        ranks_s = time.perf_counter() - t1
        elastic = phase14_scale_down(dev, ckpt_dir, reps)
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    bad = list(elastic["bad"])
    o32 = one["float32"]["steps"][0]
    for r in reps:
        for dt, rec in r["runs"].items():
            for i, st in enumerate(rec["steps"]):
                if not st["schedule_equal"]:
                    bad.append(f"rank {r['rank']} {dt} step {i}: Wire "
                               f"{st['wire']['by_kind']} is not the "
                               "schedule")
                if not (np.isfinite(st["loss"]) and np.isfinite(
                        st["grad_norm"])):
                    bad.append(f"rank {r['rank']} {dt} step {i} not finite")
        if any(r["launches"].values()):
            bad.append(f"rank {r['rank']} launched {r['launches']}")
        if r["route_calls"]["kernel"]:
            bad.append(f"rank {r['rank']} route calls {r['route_calls']}")
        m32 = r["runs"]["float32"]["steps"][0]
        for key in ("loss", "grad_norm"):
            if abs(m32[key] - o32[key]) > PHASE14_TOL[key] * abs(o32[key]):
                bad.append(f"rank {r['rank']} float32 {key} {m32[key]} "
                           f"against one rank's {o32[key]}")
        c = r["check"]
        if (max(c["moment_share"].values()) > PHASE14_TOL["moment"]
                or c["param_over"]
                or c["param_loose"] > TRAIN_PARAM_LOOSE * c["param_n"]):
            bad.append(f"rank {r['rank']} float32 state against one rank: "
                       f"{c}")
    launched = launches_before()
    if any(launched.values()):
        bad.append(f"phase 14 launched a port kernel: {launched}")
    if bad:
        fail(f"phase 14: {bad[:10]}")
    warm = [max(r["runs"]["bfloat16"]["steps"][i]["ms"] for r in reps)
            for i in range(1, 1 + PHASE14_TIMED)]
    o16 = one["bfloat16"]["steps"]
    out = {
        "arch": cfg16.name, "mesh": list(PHASE14_MESH), "ranks": RANKS,
        "reduced": {"n_layers": PHASE14_LAYERS, "global_batch": b,
                    "seq_len": s, "why": "the published 40 layers and "
                    "256 x 4,096 cut to 1 layer and phase 8b's 2 x "
                    "4,096: four ranks share one card and "
                    "every collective is staged through host memory"},
        "remat": reps[0]["runs"]["bfloat16"]["remat"],
        "warm_ms": float(np.median(warm)), "warm_ms_steps": warm,
        "cold_ms": max(r["runs"]["bfloat16"]["steps"][0]["ms"]
                       for r in reps),
        "tokens_per_s": b * s / (float(np.median(warm)) / 1e3),
        "one_rank": {"warm_ms": float(np.median([x["ms"] for x in o16[1:]])),
                     "cold_ms": o16[0]["ms"],
                     "peak_gb": one["bfloat16"]["peak_gb"],
                     "float32_ms": o32["ms"],
                     "float32_peak_gb": one["float32"]["peak_gb"]},
        "check": {"tolerance": PHASE14_TOL, "one_rank": o32,
                  "mesh": [{k: r["runs"]["float32"]["steps"][0][k]
                            for k in ("loss", "grad_norm")} for r in reps],
                  "ranks": [r["check"] for r in reps]},
        "mha_launches": [r["launches"]["flash_attention"] for r in reps],
        "kernel_launches": launched, "device": torch.cuda.get_device_name(
            dev), "one_rank_s": one_s, "ranks_s": ranks_s,
        "elastic": {k: v for k, v in elastic.items() if k != "bad"},
        "seconds": time.perf_counter() - t0,
    }
    for r in reps:
        w = r["runs"]["bfloat16"]["steps"][-1]["wire"]
        print(f"phase 14: rank {r['rank']} {r['coords']}: warm bf16 steps "
              + ", ".join(f"{x['ms']:.1f}" for x in
                          r["runs"]["bfloat16"]["steps"][1:])
              + f" ms; a warm step's collectives {w['calls']} calls "
              f"{w['ms']:.1f} ms by kind {w['ms_by_kind']}, payload "
              f"{w['payload_bytes'] / 1e9:.4f} GB, staged "
              f"{w['staged_bytes'] / 1e9:.4f} GB by kind "
              f"{w['staged_by_kind']}, by axis {w['by_axis']}; peak "
              f"{r['runs']['bfloat16']['peak_gb']:.3f} GB (float32 "
              f"{r['runs']['float32']['peak_gb']:.3f} GB); the float32 "
              f"check {r['check']}", flush=True)
    el = elastic["ranks"]
    print(f"phase 14: elastic checkpoint of the {PHASE14_MESH} float32 "
          f"state, {elastic['bytes'] / 1e9:.3f} GB: gather "
          f"{max(p['gather_s'] for p in el):.2f} s, rank 0's write "
          f"{el[0]['write_s']:.2f} s, restore on {PHASE14_RESIZE} per rank "
          + ", ".join(f"{p['restore_s']:.2f}" for p in el)
          + f" s, bitwise block_of the saved arrays; a float32 step on "
          f"{PHASE14_RESIZE} {el[0]['steps']['14']['ms']:.1f} ms and on "
          f"{PHASE14_MESH} {el[0]['steps']['22']['ms']:.1f} ms agree "
          f"within PHASE14_TOL; one-rank restore on the card "
          f"{elastic['one_rank_restore_s']:.2f} s, bitwise; peak "
          f"{max(p['peak_gb'] for p in el):.3f} GB a rank, "
          f"{elastic['one_rank_peak_gb']:.3f} GB one rank; added "
          f"{elastic['added_s']:.1f} s on {elastic['card']}", flush=True)
    print(f"phase 14: {cfg16.name} ({PHASE14_LAYERS} layers) train_4k "
          f"[{b}, {s}] on a {PHASE14_MESH} mesh of {RANKS} gloo ranks: "
          f"warm step {out['warm_ms']:.1f} ms (slowest rank; cold "
          f"{out['cold_ms']:.1f}), one rank {out['one_rank']['warm_ms']:.1f}"
          f" ms; every rank's Wire equals the schedule, mha launches "
          f"{out['mha_launches']}; {out['device']}; "
          f"{out['seconds']:.1f} s", flush=True)
    return out


# -- phase 15: MoE layers on a mesh of ranks ---------------------------------

PHASE15_ARCH = "olmoe-1b-7b"  # 64 experts, top-8, every layer MoE
PHASE15_MESH = (2, 2)  # ("data", "model"): 4 gloo ranks sharing the card
#: olmoe's 16 layers cut to 1 to serve and to train, at full width, so
#: that the phase stays inside the run's time limit (PERF.md names the
#: cuts: at 4 and 2 layers the phase took 214 s, 160 s of it in the
#: ranks' host-staged collectives)
PHASE15_LAYERS = 1
PHASE15_TRAIN_LAYERS = 1
PHASE15_PROMPTS = (4, 4096)  # prefill_32k's 32 x 32,768, cut as phase 12's
PHASE15_STEPS = 2  # decode steps against 4 x 4,098 slots (dropless)
#: train_4k's 256 x 4,096 cut to 8 x 1,024: olmoe's n_micro 4 x data 2,
#: one row a rank a microbatch
PHASE15_TRAIN = (8, 1024)
PHASE15_TIMED = 2  # bfloat16 steps on the mesh (the first one cold)
#: a prefill at this capacity factor runs the global-order drop path
#: where the published 1.25 drops nothing on the seeded weights
PHASE15_CAPACITY = 0.5
#: the float32 check holds every leaf but the experts' whole, and of
#: each expert tensor the first experts of each model rank's block
PHASE15_EXPERTS_CHECKED = 4
PHASE15_TIMEOUT_S = 600  # the rank group, or it fails
PHASE15_SEED = 15  # the prompts and the batch's tokens
PHASE15_REF = "phase15_ref"  # the one-rank float32 state, under build/
#: mesh against one rank, float32 (TF32 off): phase 6b's tolerance for
#: float32 logits, relative to the largest magnitude. bfloat16 logits are
#: compared for the record only (cosine, greedy tokens): a router's top-8
#: of 64 flips at a near tie under bfloat16 rounding in another order,
#: which swaps an expert for that token
PHASE15_F32_TOL = LM_F32_TOL
PHASE15_F32_STEPS = 1  # float32 decode steps after the float32 prefill
#: the float32 step against one rank: phase 14's, but a gradient counts
#: as rounding-sized (its step may then differ by up to 2 lr) below the
#: moments' own tolerance of the leaf's largest, not 1e-6 of it: its sign
#: is not determined at the precision the moments are held to (olmoe's
#: attention gradients differ between the ranks' sums and one rank's by
#: about 1e-5 of their largest, MiniCPM's by less than 1e-6)
PHASE15_TOL = dict(PHASE14_TOL, rounding=PHASE14_TOL["moment"])
#: mha at the ranks' shape, (B 2, H 8, S 4,096, D 128): 2 rows a data
#: rank, 8 of olmoe's 16 heads a model rank
PHASE15_MHA = (2, 8, 4096, 128)


def phase15_spec(n_layers: int, dtype=None, capacity=None):
    """olmoe-1b-7b with its full config cut to ``n_layers``, in
    ``dtype`` if given, at ``capacity`` (a capacity factor) if given."""
    from repro_torch.configs import base

    spec = base.get(PHASE15_ARCH)
    cfg = dataclasses.replace(spec.full_config(), n_layers=n_layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if capacity is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity))
    return dataclasses.replace(spec, full_config=lambda: cfg)


def phase15_cells(mesh, capacity=None, dtype=None):
    """The prefill (``PHASE15_PROMPTS``) and decode (their cache and
    ``PHASE15_STEPS``) cells at ``PHASE15_LAYERS``."""
    from repro_torch.launch import steps

    spec = phase15_spec(PHASE15_LAYERS, dtype, capacity)
    b, s = PHASE15_PROMPTS
    shapes = {x.name: x for x in spec.shapes}
    pre = dataclasses.replace(shapes["prefill_32k"], dims=dict(
        seq_len=s, global_batch=b))
    dec = dataclasses.replace(shapes["decode_32k"], dims=dict(
        seq_len=s + PHASE15_STEPS, global_batch=b))
    return (steps._lm_cell(spec, pre, mesh, False),
            steps._lm_cell(spec, dec, mesh, False))


def phase15_train_cell(mesh, dtype):
    """``train_4k`` at ``PHASE15_TRAIN`` and ``PHASE15_TRAIN_LAYERS``."""
    from repro_torch.launch import steps

    spec = phase15_spec(PHASE15_TRAIN_LAYERS, dtype)
    b, s = PHASE15_TRAIN
    shape = next(x for x in spec.shapes if x.name == "train_4k")
    shape = dataclasses.replace(shape, dims=dict(seq_len=s, global_batch=b))
    return steps._lm_cell(spec, shape, mesh, False)


def phase15_schedule(cell, mesh_shape: dict, specs: dict, shapes: dict,
                     calls: int = 1) -> dict:
    """``collective_schedule`` of ``calls`` calls of ``cell`` (a
    prefill, a decode step or a train step), by kind and group."""
    from repro_torch.models import transformer_mesh as tmesh
    from repro_torch.nn.module import sharding_rules

    data = mesh_shape["data"]
    n_micro = cell.decisions.get("n_micro", 1)
    rows = cell.dims["global_batch"] // data // n_micro
    sch = tmesh.collective_schedule(
        cell.config, cell.kind, rows, cell.dims["seq_len"], mesh_shape,
        sharding_rules(False, cell.kind != "decode"), specs, shapes,
        cell.decisions.get("seq_axes", ("model",)), n_micro)
    one = tmesh.merge_records(sch["global"], *sch["layers"], sch["final"])
    return tmesh.merge_records(*[one] * calls)


def _by_kind(mesh) -> dict:
    return {k: {int(g): list(v) for g, v in d.items()}
            for k, d in mesh.wire.by_kind.items()}


def _kept(log) -> list:
    """(kept, slots) a layer of one call's ``transformer_mesh.moe_log``."""
    return [[r["kept"], r["slots"]] for r in log]


def phase15_sampled(name: str, t, mesh_shape: dict):
    """An expert tensor's checked experts: the first
    ``PHASE15_EXPERTS_CHECKED`` of each model rank's block (dim 0), so
    that the block of the result under ``spec`` is a rank's first ones;
    any other leaf whole."""
    if not name.endswith(("experts.wi.kernel", "experts.wo.kernel")):
        return t
    m = mesh_shape["model"]
    e_loc = t.shape[0] // m
    sel = [i * e_loc + j for i in range(m)
           for j in range(PHASE15_EXPERTS_CHECKED)]
    return t[sel]


def phase15_rank(rank: int, world: int, prompts: np.ndarray,
                 forced: np.ndarray, batch: dict, cap_case: bool,
                 ref_dir: str, device: str) -> dict:
    """One of four gloo ranks sharing the card: olmoe-1b-7b (seed 0, as
    the one-rank runs) at ``PHASE15_LAYERS`` cut by ``steps.shard_lm`` on
    the ``(2, 2)`` mesh, every block checked against its spec's slice; a
    cold and a warm prefill of ``prompts`` (the first ``mha`` call kept
    for rank 0's check against the plain version) and ``PHASE15_STEPS``
    decode steps fed ``forced``, in bfloat16; the same model in float32:
    the prefill, ``PHASE15_F32_STEPS`` decode steps and, with
    ``cap_case``, a prefill at ``PHASE15_CAPACITY``; then the train cell
    at ``PHASE15_TRAIN_LAYERS``: ``PHASE15_TIMED`` bfloat16 steps on the
    global ``batch`` and a float32 step from fresh weights held, block by
    block, against the one-rank state under ``ref_dir``. Returns logits
    (rank 0), timings, kept slots a layer, launches, every call's
    collectives beside the schedule, peak memory, the check's spreads
    and the wall clock at each stage of the rank's start."""
    wall = {"entry": time.time()}
    from repro_torch.kernels.binned_pull import binned_pull as bp_mod
    from repro_torch.kernels.block_spmm import block_spmm as bs_mod
    from repro_torch.kernels.flash_attention import flash_attention as fa_mod
    from repro_torch.kernels.msbfs_extend import msbfs_extend as mx_mod
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.models import transformer_mesh as tmesh
    from repro_torch.nn import attention as attn
    from repro_torch.nn.module import block_of, gather_block
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    wall["imports"] = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    torch.zeros(1, device=dev)
    wall["cuda"] = time.time()
    counters = {"binned_pull": bp_mod.fused_binned_pull,
                "msbfs_extend": mx_mod.msbfs_extend_blocks,
                "block_spmm": bs_mod.block_spmm,
                "flash_attention": fa_mod.flash_attention}

    def zero():
        for f in counters.values():
            f.launches = 0
        attn.route_calls.update(dict.fromkeys(attn.route_calls, 0))

    def launched():
        return {k: f.launches for k, f in counters.items()}

    mesh = make_mesh(PHASE15_MESH, ("data", "model"), dev)
    wall["mesh"] = time.time()
    pcell, dcell = phase15_cells(mesh)
    cfg = pcell.config
    wall["cells"] = time.time()
    out = {"rank": rank, "coords": {a: mesh.coord(a)
                                    for a in mesh.axis_names},
           "calls": {}, "section_s": {}, "wall": wall}
    clock = [time.perf_counter()]

    def section(name):
        now = time.perf_counter()
        out["section_s"][name] = now - clock[0]
        clock[0] = now
    model = tfm.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    whole = dict(model.named_parameters())
    steps.shard_lm(pcell, model, mesh)
    blocks_ok = True
    for name, p in model.named_parameters():
        blocks_ok &= torch.equal(p, _spec_block(whole[name],
                                                model.shard_specs[name],
                                                mesh))
    out["blocks_equal_spec"] = bool(blocks_ok)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    section("init")
    specs = model.shard_specs
    toks = torch.from_numpy(prompts).to(dev)
    feed = torch.from_numpy(forced).to(dev)
    b, s = prompts.shape
    out_spec = pcell.decisions["out_specs"][0]
    real_mha, first = attn.mha, []

    def keep_first(q, k, v, **kw):
        if not first:
            first.append((q.clone(), k.clone(), v.clone(), kw))
        return real_mha(q, k, v, **kw)

    def call(name, fn, cell, n_calls=1):
        """One timed call (or ``n_calls`` decode steps inside ``fn``)
        with the wire and the MoE log read around it."""
        mesh.wire.reset()
        tmesh.moe_log = []
        try:
            res, ms = _timed(fn, dev)
            log = tmesh.moe_log
        finally:
            tmesh.moe_log = None
        w = _wire13(mesh)
        w["by_kind"] = _by_kind(mesh)
        w["schedule_equal"] = w["by_kind"] == phase15_schedule(
            cell, mesh.shape, specs, shapes, n_calls)  # specs: any dtype
        out["calls"][name] = {"ms": ms, "wire": w, "kept": _kept(log)}
        return res

    torch.cuda.reset_peak_memory_stats(dev)
    attn.mha = keep_first
    try:
        zero()
        (_, caches), cold_ms = _timed(
            lambda: pcell.fn(model, toks, max_seq=s + PHASE15_STEPS), dev)
        out["cold_launches"] = launched()
        del caches
        zero()
        logits, caches = call("prefill", lambda: pcell.fn(
            model, toks, max_seq=s + PHASE15_STEPS), pcell)
        out["launches"] = launched()
        out["route_calls"] = dict(attn.route_calls)
    finally:
        attn.mha = real_mha
    out["prefill_cold_ms"] = cold_ms
    rows = [gather_block(logits, out_spec, mesh)[:, :cfg.vocab].float()
            .cpu()]
    if rank == 0:  # the first call against the plain version
        q, k, v, kw = first[0]
        got = real_mha(q, k, v, **kw)
        exp = real_mha(q, k, v, use_ref=True, **kw)
        torch.cuda.synchronize(dev)
        out["mha_check"] = {
            "shape": list(q.shape), "dtype": str(q.dtype).split(".")[-1],
            "max_abs_err": max_abs_err(got, exp),
            "ok": bool(torch.allclose(got.float(), exp.float(),
                                      rtol=ATTN_TOL[torch.bfloat16][0],
                                      atol=ATTN_TOL[torch.bfloat16][1]))}
    del first[:]

    def decode():
        nonlocal caches
        got, ms = [], []
        for t in range(feed.shape[1]):
            (o, caches), step = _timed(lambda: dcell.fn(
                model, caches, feed[:, t:t + 1], s + t), dev)
            ms.append(step)
            got.append(o[:, 0])
        return got, ms

    zero()
    got, step_ms = call("decode", decode, dcell, PHASE15_STEPS)
    rows += [gather_block(o, out_spec, mesh)[:, :cfg.vocab].float().cpu()
             for o in got]  # after the calls' wire was read
    out["decode_launches"] = launched()
    out["decode_step_ms"] = step_ms
    out["serve_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["digest"] = _digest(torch.stack(rows).numpy())
    if rank == 0:
        out["logits"] = [r.numpy() for r in rows]
    del model, caches, logits, got
    gc.collect()
    torch.cuda.empty_cache()
    section("serve_bf16")

    # float32 (TF32 off): the prefill, a decode step and, with
    # ``cap_case``, a prefill at PHASE15_CAPACITY, held against one rank
    fcell, fdcell = phase15_cells(mesh, dtype=torch.float32)
    model = tfm.init(fcell.config,
                     torch.Generator(device=dev).manual_seed(0), dev)
    steps.shard_lm(fcell, model, mesh)
    f32 = {}
    zero()
    logits, caches = call("prefill_f32", lambda: fcell.fn(
        model, toks, max_seq=s + PHASE15_STEPS), fcell)
    f32["prefill"] = logits
    for t in range(PHASE15_F32_STEPS):
        o, caches = call(f"decode_f32_{t}", lambda: fdcell.fn(
            model, caches, feed[:, t:t + 1], s + t), fdcell)
        f32[f"decode_{t}"] = o[:, 0]
    del caches
    if cap_case:
        ccell, _ = phase15_cells(mesh, PHASE15_CAPACITY, torch.float32)
        f32["capacity"], _ = call("capacity_f32", lambda: ccell.fn(
            model, toks), ccell)
    f32 = {k: gather_block(v, out_spec, mesh)[:, :cfg.vocab].cpu().numpy()
           for k, v in f32.items()}  # on every rank
    out["f32_digest"] = _digest(np.stack(list(f32.values())))
    if rank == 0:
        out["f32_logits"] = f32
    out["f32_launches"] = launched()
    del model, logits, o
    gc.collect()
    torch.cuda.empty_cache()
    section("serve_f32")

    # training: bfloat16 steps, then a float32 step checked
    gbatch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    out["train"] = {}
    zero()
    for dtype, n_steps in ((torch.bfloat16, PHASE15_TIMED),
                           (torch.float32, 1)):
        tcell = phase15_train_cell(mesh, dtype)
        tcfg = tcell.config
        model = tfm.init(tcfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
        tshapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
        steps.shard_lm(tcell, model, mesh)
        model.requires_grad_(True)
        opt = adamw_init(steps.params_dict(model), AdamWConfig(
            moment_dtype=steps._moment_dtype(tcfg)))
        want = phase15_schedule(tcell, mesh.shape, model.shard_specs,
                                tshapes)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        rec = {"steps": [], "remat": tcell.decisions["remat"],
               "n_micro": tcell.decisions["n_micro"]}
        for _ in range(n_steps):
            mesh.wire.reset()
            (_, opt, loss, gnorm), ms = _timed(
                lambda: tcell.fn(model, opt, gbatch), dev)
            w = _wire13(mesh)
            w["by_kind"] = _by_kind(mesh)
            rec["steps"].append({"ms": ms, "loss": float(loss),
                                 "grad_norm": float(gnorm), "wire": w,
                                 "schedule_equal": w["by_kind"] == want})
        rec["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        out["train"][str(dtype).split(".")[-1]] = rec
        section(f"train_{str(dtype).split('.')[-1]}")
        if dtype == torch.bfloat16:
            del model, opt
            gc.collect()
            torch.cuda.empty_cache()
    out["train_launches"] = launched()
    out["train_route_calls"] = dict(attn.route_calls)
    # the float32 step, block by block, against the one-rank state
    with open(os.path.join(ref_dir, "max.json")) as f:
        top = json.load(f)
    lr, specs = 3e-4, model.shard_specs
    mine = {"params": {k: p.detach() for k, p in model.named_parameters()},
            "mu": opt.mu, "nu": opt.nu}
    share = {"mu": 0.0, "nu": 0.0}
    worst, over_at = {}, {}
    n = loose = over = tiny_n = 0
    p_max = 0.0
    for name, spec in specs.items():
        cut = name.endswith(("experts.wi.kernel", "experts.wo.kernel"))
        ref = {part: torch.from_numpy(np.array(block_of(
            np.load(os.path.join(ref_dir, f"{part}.{name}.npy"),
                    mmap_mode="r"), spec, mesh))).to(dev)
            for part in mine}
        have = {part: (mine[part][name][:PHASE15_EXPERTS_CHECKED] if cut
                       else mine[part][name]) for part in mine}
        for part in ("mu", "nu"):
            e = float((have[part].float() - ref[part]).abs().max())
            e /= max(top[part][name], 1e-30)
            worst[f"{part} {name}"] = e
            share[part] = max(share[part], e)
        d = (have["params"].float() - ref["params"]).abs()
        tiny = ref["mu"].abs() <= PHASE15_TOL["rounding"] * top["mu"][name]
        p_max = max(p_max, float(d.max()))
        bad_at = ((d > 0.1 * lr) & ~tiny) | (d > 2 * lr)
        if bad_at.any():  # where, against the leaf's gradients
            g_ref = ref["mu"][bad_at].abs()
            over_at[name] = {
                "n": int(bad_at.sum()),
                "ref_mu_max": float(g_ref.max()) / top["mu"][name],
                "mu_diff_max": float((have["mu"].float() - ref["mu"])[
                    bad_at].abs().max()) / top["mu"][name]}
        over += int(((d > 0.1 * lr) & ~tiny).sum()) + int((d > 2 * lr).sum())
        tiny_n += int(tiny.sum())
        n += d.numel()
        loose += int((d > TRAIN_PARAM_ABS).sum())
        del ref, d, tiny
    out["check"] = {"moment_share": share, "param_max_abs": p_max,
                    "param_over": over, "param_loose": loose,
                    "param_n": n, "tiny_gradients": tiny_n,
                    "worst_leaf": max(worst.items(), key=lambda kv: kv[1]),
                    "over_by_leaf": over_at}
    section("check")
    out["wall"]["return"] = time.time()
    return out


def _vs_one_rank(got: list, ref: list) -> list:
    """Each step's logits rows of the mesh against one rank's, for the
    record: the smallest cosine, the largest difference and the greedy
    tokens (phase 12's measures)."""
    rows = []
    for t, (g, r) in enumerate(zip(got, ref)):
        g = torch.as_tensor(g)
        r = torch.as_tensor(r)
        cos = torch.nn.functional.cosine_similarity(g.double(), r.double(),
                                                    dim=-1)
        delta = (g - r).abs().max(dim=-1).values
        top2 = r.topk(2, dim=-1).values
        clear = top2[:, 0] - top2[:, 1] > 2 * delta
        agree = g.argmax(-1) == r.argmax(-1)
        rows.append({"step": t, "min_cosine": float(cos.min()),
                     "max_abs": float(delta.max()),
                     "max_rel": float(delta.max() / r.abs().max()),
                     "tokens_clear": int(clear.sum()),
                     "tokens_equal": int(agree.sum()),
                     "clear_and_unequal": int((clear & ~agree).sum())})
    return rows


def phase_15(dev, launches_before) -> dict:
    """olmoe-1b-7b's prefill, decode and train cells
    (``models/transformer_mesh.py``'s expert-parallel MoE) on a ``(2, 2)``
    mesh of four gloo ranks sharing the card, against the one-rank port
    on the card from the same seeded weights (the steps in the module
    docstring)."""
    import shutil

    from repro_torch.kernels.flash_attention.ops import mha
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh, run_ranks
    from repro_torch.models import transformer as tfm
    from repro_torch.models import transformer_mesh as tmesh
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = phase15_spec(PHASE15_LAYERS).full_config()
    b, s = PHASE15_PROMPTS
    max_seq = s + PHASE15_STEPS
    rng = np.random.default_rng(PHASE15_SEED)
    prompts = rng.integers(0, cfg.vocab, (b, s))
    # one rank through transformer.prefill/decode (nn/moe.py on the card)
    model = tfm.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    toks = torch.from_numpy(prompts).to(dev)
    tfm.prefill(model, cfg, toks, max_seq=max_seq)  # cold
    torch.cuda.reset_peak_memory_stats(dev)
    (last, caches), pre_ms = _timed(
        lambda: tfm.prefill(model, cfg, toks, max_seq=max_seq), dev)
    one = {"prefill_ms": pre_ms}
    ref = [last[:, :cfg.vocab].float()]
    fed, step_ms = [], []
    for t in range(PHASE15_STEPS):
        tok = ref[-1].argmax(-1, keepdim=True)
        fed.append(tok)
        (o, caches), ms = _timed(
            lambda: tfm.decode(model, cfg, caches, tok, s + t), dev)
        step_ms.append(ms)
        ref.append(o[:, 0, :cfg.vocab].float())
    one.update(decode_step_ms=step_ms,
               decode_ms_per_step=float(np.median(step_ms)),
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    ref = [r.cpu() for r in ref]
    forced = torch.cat(fed, dim=1).cpu().numpy()
    del caches, o, last
    one_clock = {"serve_bf16": time.perf_counter() - t0}
    # the one-rank cell (transformer_mesh on a (1, 1) mesh): slots kept a
    # layer at the published capacity factor, bfloat16
    one_mesh = make_mesh((1, 1), ("data", "model"), dev)
    pcell1, _ = phase15_cells(one_mesh)
    steps.shard_lm(pcell1, model, one_mesh)
    tmesh.moe_log = []
    try:
        pcell1.fn(model, toks, max_seq=max_seq)
        kept = _kept(tmesh.moe_log)
    finally:
        tmesh.moe_log = None
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # float32 (TF32 off): the prefill and a decode step through nn/moe.py,
    # the one-rank cell's kept slots and, where 1.25 drops nothing, both
    # again at PHASE15_CAPACITY
    fcfg = phase15_spec(PHASE15_LAYERS, torch.float32).full_config()
    model = tfm.init(fcfg, torch.Generator(device=dev).manual_seed(0), dev)
    last, caches = tfm.prefill(model, fcfg, toks, max_seq=max_seq)
    f32 = {"prefill": last}
    for t in range(PHASE15_F32_STEPS):
        o, caches = tfm.decode(model, fcfg, caches,
                               torch.from_numpy(forced[:, t:t + 1]).to(dev),
                               s + t)
        f32[f"decode_{t}"] = o[:, 0]
    del caches, o, last
    fcell1, _ = phase15_cells(one_mesh, dtype=torch.float32)
    steps.shard_lm(fcell1, model, one_mesh)
    tmesh.moe_log = []
    try:
        fcell1.fn(model, toks, max_seq=max_seq)
        kept32 = _kept(tmesh.moe_log)
    finally:
        tmesh.moe_log = None
    cap_case = all(k == n for k, n in kept32)
    kept_cap = None
    if cap_case:  # nothing dropped at 1.25: the drop path at 0.5
        ccfg = phase15_spec(PHASE15_LAYERS, torch.float32,
                            PHASE15_CAPACITY).full_config()
        f32["capacity"] = tfm.prefill(model, ccfg, toks)[0]
        ccell1, _ = phase15_cells(one_mesh, PHASE15_CAPACITY, torch.float32)
        tmesh.moe_log = []
        try:
            ccell1.fn(model, toks)
            kept_cap = _kept(tmesh.moe_log)
        finally:
            tmesh.moe_log = None
    f32 = {k: v[:, :cfg.vocab].cpu().numpy() for k, v in f32.items()}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    one_clock["serve_f32"] = time.perf_counter() - t0
    # training: the one-rank train cell, bfloat16 steps then a float32
    # step whose state (the checked experts of it) is the reference
    tb, ts = PHASE15_TRAIN
    toks_t = np.random.default_rng(PHASE15_SEED + 1).integers(
        0, cfg.vocab, (tb, ts + 1)).astype(np.int32)
    batch = {"tokens": toks_t[:, :-1], "labels": toks_t[:, 1:]}
    dbatch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    ref_dir = ROOT / "build" / PHASE15_REF
    shutil.rmtree(ref_dir, ignore_errors=True)
    ref_dir.mkdir(parents=True)
    one["train"] = {}
    for dtype, n_steps in ((torch.bfloat16, PHASE15_TIMED),
                           (torch.float32, 1)):
        tcell = phase15_train_cell(one_mesh, dtype)
        model = tfm.init(tcell.config,
                         torch.Generator(device=dev).manual_seed(0), dev)
        steps.shard_lm(tcell, model, one_mesh)
        model.requires_grad_(True)
        opt = adamw_init(steps.params_dict(model), AdamWConfig(
            moment_dtype=steps._moment_dtype(tcell.config)))
        torch.cuda.reset_peak_memory_stats(dev)
        runs = []
        for _ in range(n_steps):
            (_, opt, loss, gnorm), ms = _timed(
                lambda: tcell.fn(model, opt, dbatch), dev)
            runs.append({"ms": ms, "loss": float(loss),
                         "grad_norm": float(gnorm)})
        one["train"][str(dtype).split(".")[-1]] = {
            "steps": runs,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        if dtype == torch.float32:
            top = {"mu": {}, "nu": {}}
            for part, tree in (("params", dict(model.named_parameters())),
                               ("mu", opt.mu), ("nu", opt.nu)):
                for name, t in tree.items():
                    t = t.detach()
                    if part != "params":
                        top[part][name] = float(t.abs().max())
                    np.save(ref_dir / f"{part}.{name}.npy", phase15_sampled(
                        name, t, dict(zip(("data", "model"),
                                          PHASE15_MESH))).cpu().numpy())
            (ref_dir / "max.json").write_text(json.dumps(top))
        del model, opt, tcell
        gc.collect()
        torch.cuda.empty_cache()
    del dbatch
    one_s = one_clock["train"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    spawned = time.time()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    try:
        reps = run_ranks(phase15_rank, RANKS,
                         (prompts, forced, batch, cap_case, str(ref_dir),
                          f"{DEVICE}:0"), backend="gloo",
                         timeout_s=PHASE15_TIMEOUT_S, threads=RANK_THREADS)
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
    ranks_s = time.perf_counter() - t1
    # the group's start (spawn to each rank's mesh) and end (the last
    # return to the group's join)
    lag = {f"{stage}_s": max(r["wall"][stage] for r in reps) - spawned
           for stage in ("entry", "imports", "cuda", "mesh", "cells")}
    lag["end_s"] = time.time() - max(r["wall"]["return"] for r in reps)
    bad = []
    for key in ("digest", "f32_digest"):
        if len({r[key] for r in reps}) != 1:
            bad.append(f"the ranks' gathered logits differ ({key})")
    r0 = next(r for r in reps if r["rank"] == 0)
    serve = _vs_one_rank(r0["logits"], ref)
    f32_spread = {}
    for key, exp in f32.items():  # the decisive check
        got = r0["f32_logits"][key]
        e = float(np.abs(got - exp).max()) / float(np.abs(exp).max())
        f32_spread[key] = e
        if not (np.isfinite(got).all() and e <= PHASE15_F32_TOL):
            bad.append(f"float32 {key} logits against one rank: {e} of "
                       f"the largest magnitude (tolerance "
                       f"{PHASE15_F32_TOL})")
    if not all(np.isfinite(x).all() for x in r0["logits"]):
        bad.append("bfloat16 mesh logits not finite")
    n_l = cfg.n_layers
    want = {"binned_pull": 0, "msbfs_extend": 0, "block_spmm": 0,
            "flash_attention": n_l}
    for r in reps:
        if not r["blocks_equal_spec"]:
            bad.append(f"rank {r['rank']}'s blocks are not the spec's slices")
        for what in ("cold_launches", "launches"):
            if r[what] != want:
                bad.append(f"rank {r['rank']} {what} {r[what]}, not {want}")
        if r["route_calls"] != {"kernel": n_l, "scan": 0}:
            bad.append(f"rank {r['rank']} route calls {r['route_calls']}")
        if r["f32_launches"]["flash_attention"] != n_l * (1 + cap_case):
            bad.append(f"rank {r['rank']} float32 prefill launches "
                       f"{r['f32_launches']}")
        for what in ("decode_launches", "train_launches"):
            if any(r[what].values()):
                bad.append(f"rank {r['rank']} {what} {r[what]}")
        if r["train_route_calls"]["kernel"]:
            bad.append(f"rank {r['rank']} train route calls "
                       f"{r['train_route_calls']}")
        for name, c in r["calls"].items():
            if not c["wire"]["schedule_equal"]:
                bad.append(f"rank {r['rank']} {name}: Wire "
                           f"{c['wire']['by_kind']} is not the schedule")
        for dt, rec in r["train"].items():
            for i, st in enumerate(rec["steps"]):
                if not st["schedule_equal"]:
                    bad.append(f"rank {r['rank']} {dt} step {i}: Wire "
                               f"{st['wire']['by_kind']} is not the "
                               "schedule")
                if not (np.isfinite(st["loss"])
                        and np.isfinite(st["grad_norm"])):
                    bad.append(f"rank {r['rank']} {dt} step {i} not finite")
        m32 = r["train"]["float32"]["steps"][0]
        o32 = one["train"]["float32"]["steps"][0]
        for key in ("loss", "grad_norm"):
            if abs(m32[key] - o32[key]) > PHASE15_TOL[key] * abs(o32[key]):
                bad.append(f"rank {r['rank']} float32 {key} {m32[key]} "
                           f"against one rank's {o32[key]}")
        c = r["check"]
        if (max(c["moment_share"].values()) > PHASE15_TOL["moment"]
                or c["param_over"]
                or c["param_loose"] > TRAIN_PARAM_LOOSE * c["param_n"]):
            bad.append(f"rank {r['rank']} float32 state against one rank: "
                       f"{c}")
    mc = r0["mha_check"]
    if not mc["ok"] or mc["shape"] != list(PHASE15_MHA):
        bad.append(f"rank 0's first mha call against its plain version: "
                   f"{mc}")
    launched = launches_before()
    if launched != {**dict.fromkeys(launched, 0),
                    "flash_attention": launched["flash_attention"]}:
        bad.append(f"phase 15 launched another kernel: {launched}")
    # the slots kept a layer over the whole batch: the data ranks' sums
    # (the model ranks of a data block route the same tokens)
    def kept_total(call):
        return [[sum(r["calls"][call]["kept"][i][j] for r in reps
                     if r["coords"]["model"] == 0) for j in (0, 1)]
                for i in range(n_l)]

    # mha at the ranks' shape, alone on the card: seeded q, k, v
    gen = torch.Generator(device=dev).manual_seed(PHASE15_SEED)
    qkv = [torch.randn(PHASE15_MHA, generator=gen, device=dev,
                       dtype=torch.bfloat16) for _ in range(3)]
    mb, mh, ms_, md = PHASE15_MHA
    pairs = ms_ * (ms_ + 1) // 2
    fa_ops = 4 * md * pairs * mb * mh
    fa_bytes = 4 * 2 * qkv[0].numel()
    mha_t = {
        "shape": list(PHASE15_MHA), "dtype": "bfloat16",
        "ms": time_ms(lambda: mha(*qkv, causal=True), reps=5),
        "plain_ms": time_ms(lambda: mha(*qkv, causal=True, use_ref=True),
                            reps=2, rounds=3),
        "bound_ms": max(fa_bytes / HBM_BYTES_PER_S,
                        fa_ops / BF16_OPS_PER_S) * 1e3,
        "bound_by": ("bytes" if fa_bytes / HBM_BYTES_PER_S
                     >= fa_ops / BF16_OPS_PER_S else "operations"),
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                *qkv, is_causal=True), reps=5),
        "launches_per_prefill": [r["launches"]["flash_attention"]
                                 for r in reps],
        "max_abs_err": mc["max_abs_err"],
    }
    del qkv
    prefill_ms = max(r["calls"]["prefill"]["ms"] for r in reps)
    step = float(np.median([max(r["decode_step_ms"][t] for r in reps)
                            for t in range(PHASE15_STEPS)]))
    warm = [max(r["train"]["bfloat16"]["steps"][i]["ms"] for r in reps)
            for i in range(1, PHASE15_TIMED)]
    o16 = one["train"]["bfloat16"]["steps"]
    for r in reps:
        r.pop("logits", None)
        r.pop("f32_logits", None)
    out = {
        "arch": cfg.name, "mesh": list(PHASE15_MESH), "ranks": RANKS,
        "dtype": "bfloat16",
        "reduced": {
            "serve": {"n_layers": PHASE15_LAYERS, "prompts": [b, s],
                      "cache": [b, max_seq], "decode_steps": PHASE15_STEPS},
            "train": {"n_layers": PHASE15_TRAIN_LAYERS,
                      "global_batch": tb, "seq_len": ts},
            "why": f"olmoe's 16 layers cut to {PHASE15_LAYERS} (serving) "
                   f"and {PHASE15_TRAIN_LAYERS} (training), prefill_32k's 32 x 32,768 to phase 12's 4 "
                   "x 4,096, train_4k's 256 x 4,096 to 8 x 1,024 (n_micro "
                   "4 x data 2): four ranks share one card and every "
                   "collective is staged through host memory",
            "float32_check": f"every leaf whole but the expert tensors, "
                             f"of which the first "
                             f"{PHASE15_EXPERTS_CHECKED} experts of each "
                             "model rank's block"},
        "capacity_factor": cfg.moe.capacity_factor,
        "kept_per_layer": {"one_rank": kept,
                           "mesh": kept_total("prefill"),
                           "float32_one_rank": kept32,
                           "float32_mesh": kept_total("prefill_f32")},
        "decode_kept_per_layer": kept_total("decode"),
        "capacity_case": None if not cap_case else {
            "capacity_factor": PHASE15_CAPACITY,
            "one_rank_kept": kept_cap,
            "mesh_kept": kept_total("capacity_f32")},
        "float32_vs_one_rank": f32_spread,
        "prefill_ms": prefill_ms,
        "prefill_cold_ms": max(r["prefill_cold_ms"] for r in reps),
        "prefill_tokens_per_s": b * s / (prefill_ms / 1e3),
        "decode_ms_per_step": step,
        "decode_tokens_per_s": b / (step / 1e3),
        "train_warm_ms": warm, "train_cold_ms": max(
            r["train"]["bfloat16"]["steps"][0]["ms"] for r in reps),
        "train_tokens_per_s": tb * ts / (float(np.median(warm)) / 1e3),
        "bfloat16_vs_one_rank": serve,
        "tolerance": {"float32_logits": PHASE15_F32_TOL,
                      "float32_train": PHASE15_TOL},
        "one_rank": {**one, "prefill_tokens_per_s":
                     b * s / (one["prefill_ms"] / 1e3),
                     "train_warm_ms": [x["ms"] for x in o16[1:]]},
        "check": [r["check"] for r in reps],
        "float32_step": {"one_rank": one["train"]["float32"]["steps"][0],
                         "mesh": [{k: r["train"]["float32"]["steps"][0][k]
                                   for k in ("loss", "grad_norm")}
                                  for r in reps]},
        "mha": mha_t, "kernel_launches": launched,
        "device": torch.cuda.get_device_name(dev), "one_rank_s": one_s,
        "one_rank_clock_s": one_clock, "ranks_s": ranks_s, "ranks_lag": lag,
        "rank_sections_s": [r["section_s"] for r in reps],
        "seconds": time.perf_counter() - t0,
    }
    for r in reps:
        pw, dw = r["calls"]["prefill"]["wire"], r["calls"]["decode"]["wire"]
        tw = r["train"]["bfloat16"]["steps"][-1]["wire"]
        print(f"phase 15: rank {r['rank']} {r['coords']}: prefill "
              f"{r['calls']['prefill']['ms']:.1f} ms, collectives "
              f"{pw['calls']} calls {pw['ms']:.1f} ms by kind "
              f"{pw['ms_by_kind']}, payload {pw['payload_bytes'] / 1e9:.4f}"
              f" GB, staged {pw['staged_bytes'] / 1e9:.4f} GB by kind "
              f"{pw['staged_by_kind']}, by axis {pw['by_axis']}; decode "
              f"{PHASE15_STEPS} steps {sum(r['decode_step_ms']):.1f} ms, "
              f"collectives {dw['ms']:.1f} ms, staged "
              f"{dw['staged_bytes'] / 1e9:.4f} GB; serving peak "
              f"{r['serve_peak_gb']:.3f} GB; train steps "
              + ", ".join(f"{x['ms']:.1f}" for x in
                          r["train"]["bfloat16"]["steps"])
              + f" ms, a step's collectives {tw['calls']} calls "
              f"{tw['ms']:.1f} ms by kind {tw['ms_by_kind']}, payload "
              f"{tw['payload_bytes'] / 1e9:.4f} GB, staged "
              f"{tw['staged_bytes'] / 1e9:.4f} GB by axis {tw['by_axis']}; "
              f"train peak {r['train']['bfloat16']['peak_gb']:.3f} GB "
              f"(float32 {r['train']['float32']['peak_gb']:.3f}); the "
              f"float32 check {r['check']}", flush=True)
    print(f"phase 15: {cfg.name} ({n_l} layers) on a {PHASE15_MESH} mesh "
          f"of {RANKS} gloo ranks: prefill [{b}, {s}] {prefill_ms:.1f} ms "
          f"({out['prefill_tokens_per_s']:.0f} tokens/s), decode "
          f"{step:.1f} ms a step; one rank prefill {one['prefill_ms']:.1f} "
          f"ms, decode {one['decode_ms_per_step']:.1f} ms a step; kept "
          f"slots a layer {out['kept_per_layer']['mesh']} (one rank "
          f"{kept}); train [{tb}, {ts}] ({PHASE15_TRAIN_LAYERS} layers) "
          f"warm {warm} ms against one rank's "
          f"{out['one_rank']['train_warm_ms']}; float32 logits within "
          f"{max(f32_spread.values()):.3e} of one rank's largest "
          f"(bfloat16 min cosine {min(x['min_cosine'] for x in serve):.6f}"
          f"); mha "
          f"{mha_t['ms']:.4f} ms at {list(PHASE15_MHA)} (SDPA "
          f"{mha_t['library_ms']:.4f}); {out['device']}; "
          f"{out['seconds']:.1f} s (one rank {one_clock}, rank 0 "
          f"{r0['section_s']}, the group's {lag})", flush=True)
    if bad:
        fail(f"phase 15: {bad[:10]}")
    return out


def cell_dims(shape: str) -> dict:
    from repro_torch.configs import base

    return next(s.dims for s in base.get(PAPER_ARCH).shapes
                if s.name == shape)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # phase 8c runs under torch.use_deterministic_algorithms, whose cuBLAS
    # check asks for this setting (32 MiB of workspace, PyTorch's default
    # on Hopper); set before the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from repro_torch.graph import csr as gcsr
    from repro_torch.graph.delta import GraphDelta, apply_delta_csr
    from repro_torch.graph.generators import (
        PAPER_DATASETS,
        erdos_renyi,
        powerlaw,
    )
    from repro_torch.graph.partition import padded_n
    from repro_torch.kernels import build
    from repro_torch.kernels.binned_pull import binned_pull as bp_mod
    from repro_torch.kernels.binned_pull.binned_pull import LANE_OPS, OPS
    from repro_torch.kernels.binned_pull.ops import (
        binned_pull,
        build_pack,
        launch_record,
    )
    from repro_torch.kernels.block_spmm import block_spmm as bs_mod
    from repro_torch.kernels.block_spmm.ops import (
        compact_blocks,
        spmm,
        spmm_blocks_from_csr,
        spmm_blocks_from_numpy,
    )
    from repro_torch.kernels.common import to_device
    from repro_torch.kernels.flash_attention import flash_attention as fa_mod
    from repro_torch.kernels.flash_attention.ops import mha
    from repro_torch.kernels.msbfs_extend import msbfs_extend as mx_mod
    from repro_torch.kernels.msbfs_extend.ops import (
        extend_blocks,
        prepare_kernel_blocks,
    )
    from repro_torch.launch import serve
    from repro_torch.runtime.dispatch import QueryDispatcher
    from repro_torch.runtime.service import unpack_levels

    dev = torch.device(DEVICE, 0)
    torch.cuda.set_device(dev)
    # float32 products in full float32 (plain versions and yardsticks)
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()
    phase_s: dict = {}
    current = [None, t_start]

    def mark(phase):
        """Close the running phase's clock and start ``phase``'s."""
        now = time.perf_counter()
        if current[0] is not None:
            phase_s[current[0]] = now - current[1]
        current[:] = [phase, now]

    mark("1")
    # -- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    secs = build.build_all()
    print(f"phase 1: built {sorted(secs)} in "
          f"{time.perf_counter() - t0:.1f} s (per kernel: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(secs.items()))
          + ")", flush=True)

    mark("2")
    # -- phase 2: kernels against their plain versions ----------------------
    t0 = time.perf_counter()
    csr = PAPER_DATASETS["ldbc"](SCALE)
    print(f"ldbc proxy scale {SCALE:g}: {csr.n_nodes} nodes, {csr.n_edges} "
          f"edges, max out-degree {int(csr.degrees.max())}", flush=True)
    rng = np.random.default_rng(0)
    names = ("binned_pull", "msbfs_extend", "block_spmm", "flash_attention")
    err = dict.fromkeys(names, 0.0)
    cases = dict.fromkeys(names, 0)

    def check(kernel, got, exp, what, tol=None):
        """Bitwise (``tol`` None) or within ``tol = (rtol, atol)``; returns
        the max abs error."""
        e = max_abs_err(got, exp)
        err[kernel] = max(err[kernel], e)
        cases[kernel] += 1
        ok = (torch.equal(got, exp) if tol is None else
              torch.allclose(got.float(), exp.float(), rtol=tol[0],
                             atol=tol[1]))
        if not ok:
            fail(f"{kernel} differs from its plain version on {what} "
                 f"(max abs err {e})")
        return e

    fixtures = [
        ("ldbc-10", csr),
        ("star", star_csr(5000, gcsr.csr_from_edges)),
        ("hub", hub_csr(3000, gcsr.csr_from_edges)),
        ("hub-chunks", hub_csr(4 * bp_mod.CHUNK, gcsr.csr_from_edges)),
    ]
    ldbc_pack = None
    for fname, g in fixtures:
        n_pad = padded_n(g.n_nodes, 1, 32)
        wts = np.random.default_rng(1).uniform(0.1, 2.0, g.n_edges)
        gw = gcsr.CSRGraph(g.indptr, g.indices, wts.astype(np.float32))
        pack = to_device(build_pack(gcsr.binned_rev_csr(gw, n_pad), n_pad),
                         dev)
        if fname == "ldbc-10":
            ldbc_pack = pack
        rows = pack.rows_local
        for op in OPS:
            for lanes in ((1, 3, 64, 130) if op in LANE_OPS else (1,)):
                shape = (n_pad, lanes) if op in LANE_OPS else (n_pad,)
                vshape = (rows, lanes) if op in LANE_OPS else (rows,)
                if op == "min_dist":
                    gsrc = torch.tensor(np.where(
                        rng.random(n_pad) < 0.3, rng.uniform(0, 9, n_pad),
                        np.inf).astype(np.float32), device=dev)
                    vlocs = {"none": None}
                else:
                    gsrc = torch.tensor(
                        (rng.random(shape) < 0.3).astype(np.uint8),
                        device=dev)
                    vlocs = {
                        "none": None,
                        "partial": torch.tensor(
                            (rng.random(vshape) < 0.4).astype(np.uint8),
                            device=dev),
                        "all": torch.ones(vshape, dtype=torch.uint8,
                                          device=dev),
                    }
                for vname, v in vlocs.items():
                    got = binned_pull(pack, gsrc, v, op=op)
                    exp = binned_pull(pack, gsrc, v, op=op, use_ref=True)
                    torch.cuda.synchronize()
                    check("binned_pull", got, exp,
                          f"{fname}/{op}/L{lanes}/vloc {vname}")
        del pack
    n_blk = padded_n(csr.n_nodes, 1, 128)
    sb = to_device(gcsr.sharded_blocks_from_csr(csr, n_blk, 1, 128), dev)
    kb = to_device(prepare_kernel_blocks(gcsr.blocks_from_csr(csr, 128)),
                   dev)
    g_blk = n_blk // 128
    print(f"block operands: {int(sb.blocks.shape[1])} ShardedBlocks tiles, "
          f"{int(kb.blocks.shape[0])} KernelBlocks tiles", flush=True)
    for bname, blocks, brows, bcols in (
        ("ShardedBlocks", sb.blocks[0], sb.block_rows[0], sb.block_cols[0]),
        ("KernelBlocks", kb.blocks, kb.block_rows, kb.block_cols),
    ):
        for density in (0.0, 0.001, 0.02, 0.3):
            f = (rng.random((g_blk, 128, 64)) < density).astype(np.uint8)
            f[::3] = 0  # every third stripe empty
            fl = torch.tensor(f, device=dev)
            got = extend_blocks(blocks, brows, bcols, fl, g_out=g_blk)
            exp = extend_blocks(blocks, brows, bcols, fl, g_out=g_blk,
                                use_ref=True)
            torch.cuda.synchronize()
            check("msbfs_extend", got, exp, f"{bname}/density {density}")
    del kb
    # both reach kernels on operands a graph delta folded on the card
    g_sw, d_sw = swap_graph(gcsr.csr_from_edges, GraphDelta)
    disp = QueryDispatcher(dev, g_sw, max_iters=16)
    disp.query(np.array([20, 25], np.int32), backend="pull_binned_fused")
    (bundle,) = disp._graphs.values()
    old_pack = bundle.ops.rev_binned_pack
    old_rec = launch_record(old_pack)
    rep = disp.apply_delta(d_sw)
    pack = bundle.ops.rev_binned_pack
    if (not rep.same_shape or rep.binned_moves <= 0
            or torch.equal(pack.perm_pad, old_pack.perm_pad)):
        fail(f"the swap delta moved no row between buckets: {rep}")
    rec = launch_record(pack)
    if rec is old_rec or not torch.equal(rec.perm_pad, pack.perm_pad[0]):
        fail("the folded pack's launch record was not rebuilt")
    n_sw, rows = int(bundle.n_pad), pack.rows_local
    for op in OPS:
        for lanes in ((1, 64, 130) if op in LANE_OPS else (1,)):
            shape = (n_sw, lanes) if op in LANE_OPS else (n_sw,)
            if op == "min_dist":
                gsrc = torch.tensor(np.where(
                    rng.random(n_sw) < 0.4, rng.uniform(0, 9, n_sw),
                    np.inf).astype(np.float32), device=dev)
                v = None
            else:
                gsrc = torch.tensor((rng.random(shape) < 0.3).astype(
                    np.uint8), device=dev)
                v = torch.tensor((rng.random((rows,) + shape[1:]) < 0.3)
                                 .astype(np.uint8), device=dev)
            got = binned_pull(pack, gsrc, v, op=op)
            exp = binned_pull(pack, gsrc, v, op=op, use_ref=True)
            torch.cuda.synchronize()
            check("binned_pull", got, exp,
                  f"pack folded by a delta ({rep.binned_moves} rows moved)"
                  f"/{op}/L{lanes}")
    g_ts, d_ts = tile_swap_graph(gcsr.csr_from_edges, GraphDelta,
                                 erdos_renyi)
    disp = QueryDispatcher(dev, g_ts, max_iters=16)
    disp.query(np.arange(4, dtype=np.int32), backend="block_mxu")
    (bundle,) = disp._graphs.values()
    rows0 = bundle.ops.blocks.block_rows[0].cpu()
    rep = disp.apply_delta(d_ts)
    fb = bundle.ops.blocks
    rows1 = fb.block_rows[0].cpu()
    if (not rep.same_shape or rows1.shape != rows0.shape
            or int((rows1 != rows0).sum()) != 1):
        fail(f"the tile delta did not move one tile into a freed slot: {rep}")
    g_t = int(bundle.n_pad) // 128
    for density in (0.02, 0.3):
        fl = torch.tensor((rng.random((g_t, 128, 64)) < density).astype(
            np.uint8), device=dev)
        tiles = (fb.blocks[0], fb.block_rows[0], fb.block_cols[0])
        got = extend_blocks(*tiles, fl, g_out=g_t)
        exp = extend_blocks(*tiles, fl, g_out=g_t, use_ref=True)
        torch.cuda.synchronize()
        check("msbfs_extend", got, exp,
              f"ShardedBlocks folded by a delta/density {density}")
    del disp, bundle, old_pack, old_rec, pack, rec, fb
    # block_spmm: a power-law graph's mean blocks without zero pads and
    # without columns 1 and 4, so columns are ragged and some are empty
    pl = powerlaw(3000, 6.0, seed=5)
    sbp = spmm_blocks_from_csr(pl, 128, "mean", device="cpu")
    keep = (sbp.blocks.flatten(1) != 0).any(dim=1).numpy()
    keep &= ~np.isin(sbp.block_cols.numpy(), (1, 4))
    sbp = spmm_blocks_from_numpy(sbp.blocks.numpy()[keep],
                                 sbp.block_rows.numpy()[keep],
                                 sbp.block_cols.numpy()[keep], dev)
    for feat in (64, 256):
        for dt in (torch.float32, torch.bfloat16):
            xs = torch.tensor(rng.standard_normal((sbp.g * 128, feat)),
                              dtype=torch.float32, device=dev).to(dt)
            sbd = dataclasses.replace(sbp, blocks=sbp.blocks.to(dt))
            got = spmm(sbd, xs)
            exp = spmm(sbd, xs, use_ref=True)
            torch.cuda.synchronize()
            check("block_spmm", got, exp, f"power-law/F {feat}/{dt}",
                  SPMM_TOL)
    # a star into node 0: one destination split into 12 chunks
    v_in = np.arange(1, 3000)
    sbd = spmm_blocks_from_csr(
        gcsr.csr_from_edges(3000, v_in, np.zeros_like(v_in)), 128, "mean",
        device=dev)
    xs = torch.tensor(rng.standard_normal((sbd.g * 128, 128)),
                      dtype=torch.float32, device=dev)
    got = spmm(sbd, xs)
    check("block_spmm", got, spmm(sbd, xs, use_ref=True),
          f"star-in/{sbd.nz.n_slots} chunks into node 0", SPMM_TOL)
    check("block_spmm", spmm(sbd, xs), got, "star-in, second launch")
    for d in (16, 48, 64, 128, 256):
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (torch.tensor(rng.standard_normal((1, 4, 512, d)),
                                    dtype=torch.float32, device=dev).to(dt)
                       for _ in range(3))
            for causal in (True, False):
                got = mha(q, k, v, causal=causal)
                exp = mha(q, k, v, causal=causal, use_ref=True)
                torch.cuda.synchronize()
                check("flash_attention", got, exp,
                      f"D {d}/{dt}/causal {causal}", ATTN_TOL[dt])
    del sbp, sbd, xs, q, k, v, got, exp
    torch.cuda.empty_cache()
    print(f"phase 2: {cases['binned_pull']} binned_pull and "
          f"{cases['msbfs_extend']} msbfs_extend cases bitwise equal to the "
          f"plain versions, {cases['block_spmm']} block_spmm and "
          f"{cases['flash_attention']} flash_attention cases within "
          f"tolerance ({time.perf_counter() - t0:.1f} s)", flush=True)

    mark("3")
    # -- phase 3: the main path ---------------------------------------------
    oracle = BFSOracle(csr)
    runs = {
        "dopt_fused x8": (["--backend", "dopt_fused",
                           "--sources-per-batch", "8", "--batches", "6"],
                          "binned_pull"),
        "recommend x64": (["--sources-per-batch", "64", "--batches", "3"],
                          "msbfs_extend"),
    }
    launches = dict.fromkeys(names, 0)
    served = {}
    main_inputs = {}
    for rname, (extra, kernel) in runs.items():
        t0 = time.perf_counter()
        records = []

        def on_batch(r):
            n = csr.n_nodes
            packed = r.policy == "ntkms"
            lv = unpack_levels(r.result.state.levels.cpu().numpy(),
                               {"q": (0, len(r.sources))}, n, packed)["q"]
            ref = oracle.levels(r.sources)
            if not np.array_equal(lv, ref):
                bad = int((lv != ref).any(axis=1).sum())
                fail(f"{rname} batch {r.index}: levels of {bad} source(s) "
                     "differ from the BFS oracle")
            records.append((r.ms, r.cold, r.policy, len(r.sources)))
            if r.index == 0:
                main_inputs[kernel] = (r.sources, ref)

        bp_mod.fused_binned_pull.launches = 0
        mx_mod.msbfs_extend_blocks.launches = 0
        rc = serve.main(["--closed-loop", "--device", str(dev),
                         "--dataset", "ldbc", "--scale", str(SCALE), *extra],
                        on_batch=on_batch)
        counts = {"binned_pull": bp_mod.fused_binned_pull.launches,
                  "msbfs_extend": mx_mod.msbfs_extend_blocks.launches}
        torch.cuda.synchronize()
        if rc != 0:
            fail(f"serve run {rname} exited {rc}")
        if counts[kernel] <= 0:
            fail(f"serve run {rname} never launched {kernel}: {counts}")
        for k, v in counts.items():
            launches[k] += v
        warm = [ms for ms, cold, _, _ in records if not cold]
        served[rname] = {
            "batches": len(records),
            "sources_per_batch": records[0][3],
            "policies": sorted({p for _, _, p, _ in records}),
            "warm_batches": len(warm),
            "warm_p50_ms": float(np.percentile(warm, 50)) if warm else None,
            "warm_p99_ms": float(np.percentile(warm, 99)) if warm else None,
            "cold_ms": float(sum(ms for ms, cold, _, _ in records if cold)),
            "launches": counts,
            "seconds": time.perf_counter() - t0,
        }
        print(f"phase 3: {rname}: " + json.dumps(served[rname]), flush=True)
        torch.cuda.empty_cache()

    mark("3b")
    # -- phase 3b: the open loop, with graph deltas mid-stream --------------
    phase_3b(dev, csr, oracle, launches)

    mark("3c")
    # -- phase 3c: the weighted relax and the non-reach query kinds ---------
    kinds = phase_3c(dev, csr, check, launches)

    mark("4")
    # -- phase 4: timings at the main path's shapes --------------------------
    # binned_pull: the dense pull of one nTkS morsel of the first served
    # batch at BFS level 2, where the direction switch pulls
    n = csr.n_nodes
    rows = ldbc_pack.rows_local
    src1, lv1 = main_inputs["binned_pull"]
    level = 2
    front = np.zeros(rows, np.uint8)
    front[:n] = lv1[0] == level
    vis = np.zeros(rows, np.uint8)
    vis[:n] = (lv1[0] >= 0) & (lv1[0] <= level)
    gsrc = torch.tensor(front, device=dev)
    vloc = torch.tensor(vis, device=dev)
    rec = launch_record(ldbc_pack)
    plan = rec.plan
    wpos = np.zeros(plan.rbp, np.int64)
    for b, w in enumerate(plan.widths):
        wpos[plan.astarts[b]: plan.astarts[b] + plan.rows_pad[b]] = w
    widths = wpos[ldbc_pack.inv_pad[0].cpu().numpy()]  # per local row
    need_slots = int(widths[vis == 0].sum())  # visited rows read nothing
    # slab ids of unvisited rows, the source mask, vloc and perm_pad in;
    # one byte per row out
    bp_bytes = (4 * need_slots + gsrc.numel() + vloc.numel()
                + 4 * plan.rbp + rows)
    bp_ops = need_slots  # one compare per slot
    # the full pass (no visited rows): every live row's slots
    full_bytes = 4 * int(widths.sum()) + gsrc.numel() + 4 * plan.rbp + rows
    full_ops = int(widths.sum())
    level2 = lambda: binned_pull(ldbc_pack, gsrc, vloc, op="reach")
    full = lambda: binned_pull(ldbc_pack, gsrc, op="reach")
    eager = {"level-2": level2(), "full pass": full()}
    replay = {k: graph_ms(f) for k, f in (("level-2", level2),
                                           ("full pass", full))}
    for k, (g_ms, got) in replay.items():
        check("binned_pull", got, eager[k], f"ldbc-10 {k}, CUDA graph replay")
    device_us = {k: kernel_us(f, "binned_pull_kernel")
                 for k, f in (("level-2", level2), ("full pass", full))}
    # the library yardstick of the full pass: the reverse CSR times the
    # frontier as a float32 column (a sum where the kernel takes a max, and
    # no visited skip)
    src_e, dst_e = csr.edge_list()
    order = np.argsort(dst_e, kind="stable")
    crow = np.zeros(rows + 1, np.int64)
    crow[1:] = np.cumsum(np.bincount(dst_e, minlength=rows))
    a_rev = torch.sparse_csr_tensor(
        torch.from_numpy(crow),
        torch.from_numpy(src_e[order].astype(np.int64)),
        torch.ones(len(order)), size=(rows, gsrc.numel())).to(dev)
    col = gsrc.float()[:, None]
    if not torch.equal((torch.sparse.mm(a_rev, col)[:, 0] > 0).to(torch.uint8),
                       eager["full pass"]):
        fail("the torch.sparse.mm yardstick computes another reach")
    full_pass = {
        "ms": time_ms(full),
        "graph_ms": replay["full pass"][0],
        "device_us": device_us["full pass"],
        "bound_ms": max(full_bytes / HBM_BYTES_PER_S,
                        full_ops / INT8_OPS_PER_S) * 1e3,
        "library_ms": time_ms(lambda: torch.sparse.mm(a_rev, col)),
        "library": "torch.sparse.mm(reverse CSR f32, frontier column), "
                   "TF32 off: the gather without the visited skip",
    }
    del col, eager
    bp = {
        "ms": time_ms(level2),
        "plain_ms": time_ms(lambda: binned_pull(
            ldbc_pack, gsrc, vloc, op="reach", use_ref=True), reps=5),
        "bound_ms": max(bp_bytes / HBM_BYTES_PER_S,
                        bp_ops / INT8_OPS_PER_S) * 1e3,
        "bound_by": ("bytes" if bp_bytes / HBM_BYTES_PER_S
                     >= bp_ops / INT8_OPS_PER_S else "operations"),
        "library_ms": None,
        "graph_ms": replay["level-2"][0],
        "device_us": device_us["level-2"],
        "full_pass": full_pass,
        "shape": f"op reach, gsrc [{gsrc.numel()}] u8, vloc [{rows}] u8, "
                 f"{len(plan.widths)} slabs, {int(widths.sum())} slots "
                 f"({need_slots} of unvisited rows), "
                 f"{rec.tasks[False, False][1]} blocks "
                 f"({rec.n_parts} hub chunks)",
    }
    # the lane ops at nTkMS's pull shape: the 64 lanes of the first nTkMS
    # batch at level 2, through the same pack
    src2, lv2 = main_inputs["msbfs_extend"]
    lanes_f = np.zeros((rows, 64), np.uint8)
    lanes_f[:n, : len(src2)] = (lv2 == level).T
    lanes_v = np.zeros((rows, 64), np.uint8)
    lanes_v[:n, : len(src2)] = ((lv2 >= 0) & (lv2 <= level)).T
    lanes_v[:, len(src2):] = 1  # no source: nothing to pull
    gl = torch.tensor(lanes_f, device=dev)
    vl = torch.tensor(lanes_v, device=dev)
    open_rows = ~lanes_v.all(axis=1)  # rows with an unvisited lane
    lane_slots = int(widths[open_rows].sum())
    lane_ops = {}
    for op, out_bytes in (("reach_lanes", 1), ("min_parent_lanes", 4)):
        fn = lambda op=op: binned_pull(ldbc_pack, gl, vl, op=op)
        got = fn()
        check("binned_pull", got, binned_pull(ldbc_pack, gl, vl, op=op,
                                              use_ref=True),
              f"ldbc-10 nTkMS level-2 {op}")
        # slab ids of rows with an unvisited lane, the 64-lane source
        # mask, vloc and perm_pad in; 64 lanes a row out
        l_bytes = (4 * lane_slots + gl.numel() + vl.numel() + 4 * plan.rbp
                   + out_bytes * rows * 64)
        l_ops = lane_slots * 64  # one compare per lane per slot
        lane_ops[op] = {
            "ms": time_ms(fn),
            "plain_ms": time_ms(lambda op=op: binned_pull(
                ldbc_pack, gl, vl, op=op, use_ref=True), reps=2, rounds=3),
            "bound_ms": max(l_bytes / HBM_BYTES_PER_S,
                            l_ops / INT8_OPS_PER_S) * 1e3,
            "bound_by": ("bytes" if l_bytes / HBM_BYTES_PER_S
                         >= l_ops / INT8_OPS_PER_S else "operations"),
            "device_us": kernel_us(fn, "binned_pull_kernel"),
            "shape": f"op {op}, gsrc [{rows}, 64] u8, vloc [{rows}, 64] u8, "
                     f"{lane_slots} slots of rows with an unvisited lane",
        }
        print(f"timed: binned_pull {op} (nTkMS level 2): wrapper "
              f"{lane_ops[op]['ms']:.4f} ms, kernel "
              f"{lane_ops[op]['device_us']} us, bound "
              f"{lane_ops[op]['bound_ms']:.6f} ms by "
              f"{lane_ops[op]['bound_by']}, plain "
              f"{lane_ops[op]['plain_ms']:.4f} ms", flush=True)
    # the lane ops' library yardstick: the reverse CSR times the 64 lanes
    # as a float32 [n, 64] matrix (the gather without the visited skip)
    gl_f = gl.float()
    if not torch.equal(
            (torch.sparse.mm(a_rev, gl_f) > 0).to(torch.uint8),
            binned_pull(ldbc_pack, gl, op="reach_lanes")):
        fail("the torch.sparse.mm lane yardstick computes another reach")
    lane_ops["reach_lanes"]["library_ms"] = time_ms(
        lambda: torch.sparse.mm(a_rev, gl_f))
    lane_ops["min_parent_lanes"]["library_ms"] = None
    lane_ops["library"] = ("torch.sparse.mm(reverse CSR f32, 64 lanes as "
                           "f32 [n, 64]), TF32 off: the gather without the "
                           "visited skip")
    print(f"timed: binned_pull lane yardstick torch.sparse.mm "
          f"{lane_ops['reach_lanes']['library_ms']:.4f} ms", flush=True)
    bp["lanes"] = lane_ops
    del gl, vl, gl_f, a_rev
    print(f"timed: binned_pull level-2: wrapper {bp['ms']:.4f} ms, CUDA "
          f"graph {bp['graph_ms']:.4f} ms a call, kernel "
          f"{bp['device_us']} us; full pass: wrapper {full_pass['ms']:.4f} "
          f"ms, graph {full_pass['graph_ms']:.4f} ms, kernel "
          f"{full_pass['device_us']} us, bound {full_pass['bound_ms']:.6f} "
          f"ms, library {full_pass['library_ms']:.4f} ms", flush=True)

    # msbfs_extend: the 64-lane frontier of the first nTkMS batch at level 2
    src2, lv2 = main_inputs["msbfs_extend"]
    fl = np.zeros((n_blk, 64), np.uint8)
    fl[:n, : len(src2)] = (lv2 == level).T
    lanes_t = torch.tensor(fl, device=dev).view(g_blk, 128, 64)
    blocks, brows, bcols = sb.blocks[0], sb.block_rows[0], sb.block_cols[0]
    act = (lanes_t != 0).any(dim=2).any(dim=1)
    valid = bcols < g_blk
    active_tiles = int((act[brows.long()] & valid).sum())
    nb = int(blocks.shape[0])
    # tiles under an active stripe, every tile's coordinates and the lane
    # mask in; the reach mask out
    mx_bytes = active_tiles * 128 * 128 + 8 * nb + 2 * lanes_t.numel()
    mx_ops = active_tiles * 2 * 128 * 128 * 64
    stripes = lanes_t[brows.long()].to(torch.bfloat16)  # [nb, B, L]
    a_t = blocks.to(torch.bfloat16).transpose(1, 2)  # [nb, B(v), B(u)]
    mx = {
        "ms": time_ms(lambda: extend_blocks(blocks, brows, bcols, lanes_t,
                                            g_out=g_blk), reps=5),
        "plain_ms": time_ms(lambda: extend_blocks(
            blocks, brows, bcols, lanes_t, g_out=g_blk, use_ref=True),
            reps=2, rounds=3),
        "bound_ms": max(mx_bytes / HBM_BYTES_PER_S,
                        mx_ops / INT8_OPS_PER_S) * 1e3,
        "bound_by": ("bytes" if mx_bytes / HBM_BYTES_PER_S
                     >= mx_ops / INT8_OPS_PER_S else "operations"),
        "library_ms": time_ms(lambda: torch.bmm(a_t, stripes), reps=2,
                              rounds=3),
        "shape": f"{nb} tiles of 128x128 int8 ({active_tiles} with an "
                 f"active stripe), lanes [{g_blk}, 128, 64] u8",
    }
    del stripes, a_t, lanes_t, blocks, brows, bcols, act, valid, sb
    del ldbc_pack, rec, gsrc, vloc, main_inputs
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 4: serve operands released, "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB still allocated",
          flush=True)

    mark("5")
    # -- phase 5: the GNN and LM kernels' entry points at full width ------
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    n_pad = padded_n(n, 1, 128)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n_pad, SPMM_FEAT), generator=gen, device=dev)
    x[n:] = 0
    qkv = [torch.randn(MHA_SHAPE, generator=gen, device=dev,
                       dtype=torch.bfloat16) for _ in range(3)]
    torch.cuda.synchronize()
    bs_mod.block_spmm.launches = 0
    fa_mod.flash_attention.launches = 0
    t1 = time.perf_counter()
    sbs = spmm_blocks_from_csr(csr, 128, "mean", device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    # the compacted view alone (built once inside the call above)
    t1 = time.perf_counter()
    nz2 = compact_blocks(sbs.blocks, sbs.block_rows, sbs.block_cols, sbs.g)
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t1
    if not all(torch.equal(getattr(nz2, f), getattr(sbs.nz, f))
               for f in ("nz_ptr", "nz_src", "nz_val", "items", "splits")):
        fail("two builds of the compacted spmm view differ")
    del nz2
    fa_mod.flash_attention.route_launches["wgmma"] = 0
    y = spmm(sbs, x)
    o = mha(*qkv, causal=True)
    torch.cuda.synchronize()
    launches["block_spmm"] = bs_mod.block_spmm.launches
    launches["flash_attention"] = fa_mod.flash_attention.launches
    wgmma_launches = fa_mod.flash_attention.route_launches["wgmma"]
    for kname in ("block_spmm", "flash_attention"):
        if launches[kname] <= 0:
            fail(f"the entry points never launched {kname}: {launches}")
    if wgmma_launches <= 0:
        fail("mha in bf16 never launched the tensor-core (wgmma) kernel")
    if y.shape != x.shape or not torch.isfinite(y).all():
        fail("spmm: output not finite or of the wrong shape")
    if o.shape != qkv[0].shape or not torch.isfinite(o).all():
        fail("mha: output not finite or of the wrong shape")
    s_err = check("block_spmm", y, spmm(sbs, x, use_ref=True),
                  "ldbc-10 mean F 128", SPMM_TOL)
    a_err = check("flash_attention", o, mha(*qkv, causal=True, use_ref=True),
                  f"MiniCPM {MHA_SHAPE} bf16 causal",
                  ATTN_TOL[torch.bfloat16])
    # the same inputs in float32, held at the float32 band: this holds the
    # float32 FMA kernel (route f32_fma) at the MiniCPM shape, where a late
    # row's output is a few hundredths, so a mis-weighted tile shows. The
    # bfloat16 run above is another kernel (wgmma, 192-row CTAs, TMA), and
    # the bfloat16 band is what holds it
    qkv32 = [t.float() for t in qkv]
    a32_err = check("flash_attention", mha(*qkv32, causal=True),
                    mha(*qkv32, causal=True, use_ref=True),
                    f"MiniCPM {MHA_SHAPE} float32 causal",
                    ATTN_TOL[torch.float32])
    del qkv32
    # an oracle outside the port: scipy float64 A^T X over the edge list
    from scipy.sparse import csr_matrix

    src, dst = csr.edge_list()
    deg_in = np.bincount(dst, minlength=n).astype(np.float64)
    w_mean = 1.0 / deg_in[dst]
    at = csr_matrix((w_mean, (dst, src)), shape=(n, n))
    x_host = x[:n].double().cpu().numpy()
    oracle = at @ x_host
    o_err = float(np.abs(y[:n].double().cpu().numpy() - oracle).max())
    if not np.allclose(y[:n].cpu().numpy(), oracle, rtol=ORACLE_TOL,
                       atol=ORACLE_TOL):
        fail(f"spmm differs from the scipy oracle (max abs err {o_err})")
    nb = int(sbs.blocks.shape[0])
    nz = sbs.nz
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 5: spmm on {nb} tiles (blocks built in {build_s:.2f} s, "
          f"of which the compacted view {compact_s:.2f} s: "
          f"{int(nz.items.shape[0])} chunks of at most {nz.chunk} nonzeros, "
          f"{int(nz.splits.shape[0])} destinations split into "
          f"{nz.n_slots} chunks) "
          f"and mha {MHA_SHAPE} bf16 causal: {launches['block_spmm']} and "
          f"{launches['flash_attention']} launches; max abs err from the "
          f"plain versions: spmm {s_err:.3g}, mha bf16 {a_err:.3g}, mha on "
          f"the same inputs in float32 {a32_err:.3g}; spmm {o_err:.3g} from "
          f"the float64 oracle; peak "
          f"device memory {peak / 1e9:.3f} GB "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    mark("6")
    # -- phase 6: timings of the GNN and LM kernels --------------------------
    nnz = int(nz.nz_src.numel())
    # the work's bytes: each nonzero's source id and weight, the offsets,
    # x in and y out (the dense tiles, 4 * nb * 128^2 bytes, are the old
    # operand's, not the work's)
    sp_bytes = (nnz * (4 + nz.nz_val.element_size()) + 8 * (nz.n_dst + 1)
                + 2 * 4 * n_pad * SPMM_FEAT)
    sp_ops = 2 * nnz * SPMM_FEAT  # one multiply-add per stored nonzero
    # what the kernel pulls through L2: one source feature row a nonzero
    gather_bytes = nnz * SPMM_FEAT * x.element_size()
    y2 = spmm(sbs, x)
    if not torch.equal(y2, y):
        fail("two spmm launches give different bits")
    del y2
    crow = np.zeros(n_pad + 1, np.int64)
    crow[1:] = np.cumsum(np.bincount(dst, minlength=n_pad))
    order = np.argsort(dst, kind="stable")
    at_t = torch.sparse_csr_tensor(
        torch.from_numpy(crow), torch.from_numpy(src[order].astype(np.int64)),
        torch.from_numpy(w_mean[order].astype(np.float32)),
        size=(n_pad, n_pad), check_invariants=True).to(dev)
    if not torch.allclose(torch.sparse.mm(at_t, x), y, rtol=ORACLE_TOL,
                          atol=ORACLE_TOL):
        fail("the torch.sparse.mm yardstick computes another function")
    # 20 back-to-back calls, as for binned_pull: with 5, the host time of
    # each round's first call (the wrapper's checks and allocations) falls
    # inside the events of a kernel this short; kernel and library alike.
    # The 5-call reading is printed too, to set the two methods side by side
    sp5 = (time_ms(lambda: spmm(sbs, x), reps=5),
           time_ms(lambda: torch.sparse.mm(at_t, x), reps=5))
    print(f"timed: block_spmm with 5 calls a round: {sp5[0]:.4f} ms, "
          f"library {sp5[1]:.4f} ms", flush=True)
    sp = {
        "ms": time_ms(lambda: spmm(sbs, x)),
        "plain_ms": time_ms(lambda: spmm(sbs, x, use_ref=True), reps=2,
                            rounds=3),
        "bound_ms": max(sp_bytes / HBM_BYTES_PER_S,
                        sp_ops / F32_OPS_PER_S) * 1e3,
        "bound_by": ("bytes" if sp_bytes / HBM_BYTES_PER_S
                     >= sp_ops / F32_OPS_PER_S else "operations"),
        "library_ms": time_ms(lambda: torch.sparse.mm(at_t, x)),
        "shape": f"{nnz} nonzeros of {nb} tiles of 128x128 f32 in "
                 f"{int(nz.items.shape[0])} chunks, x [{n_pad}, {SPMM_FEAT}] "
                 f"f32; bound from {sp_bytes} work bytes, L2 gather "
                 f"{gather_bytes} bytes; library torch.sparse.mm on a CSR "
                 "A^T, TF32 off",
    }
    del at_t, sbs, nz, x, y
    torch.cuda.empty_cache()
    b, h, s_len, d = MHA_SHAPE
    pairs = s_len * (s_len + 1) // 2  # causal (query, key) pairs
    fa_ops = 4 * d * pairs * b * h  # two products, a multiply-add each
    fa_bytes = 4 * 2 * qkv[0].numel()  # q, k, v in and o out, bf16
    fa = {
        "ms": time_ms(lambda: mha(*qkv, causal=True), reps=5),
        "plain_ms": time_ms(lambda: mha(*qkv, causal=True, use_ref=True),
                            reps=2, rounds=3),
        "bound_ms": max(fa_bytes / HBM_BYTES_PER_S,
                        fa_ops / BF16_OPS_PER_S) * 1e3,
        "bound_by": ("bytes" if fa_bytes / HBM_BYTES_PER_S
                     >= fa_ops / BF16_OPS_PER_S else "operations"),
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                *qkv, is_causal=True), reps=5),
        "shape": f"q, k, v {list(MHA_SHAPE)} bf16, causal, "
                 f"{wgmma_launches} wgmma launch(es) on the main path; "
                 "library F.scaled_dot_product_attention",
    }
    del qkv, o

    mark("6b")
    # -- phase 6b: the LM serving path at full width --------------------------
    lm = phase_6b(dev, check)
    fa["served"] = lm["served"]

    mark("7")
    # phase 11's graphs are made on the host from here on, mostly while
    # phase 7's ranks and phase 8 run; this process leaves that one a
    # core until they are made
    prefetch, paper_graphs = prefetch_paper_graphs()
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads - 1))

    def prefetched():
        """All of phase 11's graphs made: this process's threads back."""
        if all(r.ready() for r in paper_graphs.values()):
            torch.set_num_threads(threads)

    # -- phase 7: ranks sharing the card, then one NCCL rank -----------------
    ranks = phase_7(csr, BFSOracle(csr))

    def shard_times(kname):
        """Each rank's time of a kernel at its shard shape (phase 7)."""
        return {
            op.split("/")[-1]: [
                {"rank": r["rank"], **r["kernels"][op],
                 "shape": r["shapes"][kname],
                 "launches": r["launches"][kname],
                 "check_launches": r["check_launches"][kname]}
                for r in ranks["ranks"]]
            for op in ranks["ranks"][0]["kernels"] if op.startswith(kname)
        }

    mark("8")
    prefetched()
    # -- phase 8: LM training at full width ----------------------------------
    training = phase_8(dev)

    mark("9")
    prefetched()
    # -- phase 9: GNN training ---------------------------------------------
    counters = {"binned_pull": bp_mod.fused_binned_pull,
                "msbfs_extend": mx_mod.msbfs_extend_blocks,
                "block_spmm": bs_mod.block_spmm,
                "flash_attention": fa_mod.flash_attention}
    before = {k: f.launches for k, f in counters.items()}
    gnn = phase_9(dev, csr, lambda: {k: f.launches - before[k]
                                     for k, f in counters.items()})

    mark("10")
    prefetched()
    # -- phase 10: recsys, and the mesh substrate's compression and pipeline
    before = {k: f.launches for k, f in counters.items()}
    recsys = phase_10(dev, lambda: {k: f.launches - before[k]
                                    for k, f in counters.items()})

    mark("11")
    # -- phase 11: the paper engine's Table 2 cells --------------------------
    before = {k: f.launches for k, f in counters.items()}
    paper = phase_11(dev, lambda: {k: f.launches - before[k]
                                   for k, f in counters.items()},
                     paper_graphs)
    prefetch.terminate()
    prefetch.join()
    del paper_graphs
    torch.set_num_threads(threads)

    mark("12")
    # -- phase 12: the LM serving cells on a mesh of ranks --------------------
    mesh_lm = phase_12(dev, lm["serve"])

    mark("13")
    # -- phase 13: the GNN and recsys cells on a mesh of ranks ---------------
    before = {k: f.launches for k, f in counters.items()}
    mesh_cells = phase_13(dev, csr, lambda: {k: f.launches - before[k]
                                             for k, f in counters.items()})

    mark("14")
    # -- phase 14: LM training on a mesh of ranks ----------------------------
    before = {k: f.launches for k, f in counters.items()}
    mesh_train = phase_14(dev, lambda: {k: f.launches - before[k]
                                        for k, f in counters.items()})

    mark("15")
    # -- phase 15: MoE layers on a mesh of ranks -----------------------------
    before = {k: f.launches for k, f in counters.items()}
    mesh_moe = phase_15(dev, lambda: {k: f.launches - before[k]
                                      for k, f in counters.items()})
    fa["mesh"] = {"mha_launches_per_prefill":
                  mesh_lm["mha_launches_per_prefill"],
                  "mha_launches_in_training": mesh_train["mha_launches"],
                  "mesh": mesh_lm["mesh"], "olmoe": mesh_moe["mha"]}

    bp["shard"] = shard_times("binned_pull")
    mx["shard"] = shard_times("msbfs_extend")
    kernels = [
        {"name": "binned_pull", "route": "cuda", "design": "row_classes",
         "source": "src/repro_torch/kernels/csrc/binned_pull.cu",
         "replaces": "src/repro/kernels/binned_pull/binned_pull.py:198",
         "launches": launches["binned_pull"],
         "max_abs_err": err["binned_pull"], **bp,
         "min_dist": kinds["min_dist"]},
        {"name": "msbfs_extend", "route": "cuda", "design": "bit_tiles",
         "source": "src/repro_torch/kernels/csrc/msbfs_extend.cu",
         "replaces": "src/repro/kernels/msbfs_extend/msbfs_extend.py:73",
         "launches": launches["msbfs_extend"],
         "max_abs_err": err["msbfs_extend"], **mx},
        {"name": "block_spmm", "route": "cuda", "design": bs_mod.ROUTE,
         "source": "src/repro_torch/kernels/csrc/block_spmm.cu",
         "replaces": "src/repro/kernels/block_spmm/block_spmm.py:48",
         "launches": launches["block_spmm"],
         "max_abs_err": err["block_spmm"], **sp},
        {"name": "flash_attention", "route": "cuda",
         "design": fa_mod.ROUTES[torch.bfloat16],
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:77",
         "launches": launches["flash_attention"],
         "max_abs_err": err["flash_attention"], **fa},
    ]
    for k in kernels:
        print(f"timed: {k['name']}: {k['ms']:.4f} ms (plain "
              f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms by "
              f"{k['bound_by']}, library {k['library_ms']}) at {k['shape']}",
              flush=True)
    for rname, s in served.items():
        print(f"serve {rname}: warm p50 {s['warm_p50_ms']} ms, warm p99 "
              f"{s['warm_p99_ms']} ms over "
              + (f"{s['warm_batches']} warm batch(es)" if "warm_batches" in s
                 else f"{s['queries']} queries (all-in p50 "
                 f"{s['all_p50_ms']} ms, p99 {s['all_p99_ms']} ms; "
                 f"{s['cold_batches']} of {s['batches']} batches cold), "
                 f"apply_delta ms {s['apply_delta_ms']}"))
    for kind in ("topk_paths", "ppr", "pattern_counts"):
        c, o = kinds[kind]["closed"], kinds[kind]["open"]
        print(f"serve --query-kind {kind}: closed warm p50 "
              f"{c['warm_p50_ms']} ms over {c['warm_batches']} warm "
              f"batches {c['warm_ms']}; open warm p50 {o['warm_p50_ms']} ms"
              + (f", p99 {o['warm_p99_ms']} ms" if "warm_p99_ms" in o
                 else "")
              + f" over {o['warm_queries']} warm queries (all-in p50 "
              f"{o['all_p50_ms']} ms)"
              + (f"; ms per iteration {c['warm_ms_per_iteration']}"
                 if kind == "topk_paths" else ""))
    print(f"phase 3c peak device memory {kinds['peak_gb']:.3f} GB")
    lm_s = lm["serve"]
    print(f"LM serve {lm_s['arch']} bf16: prefill {lm_s['prompts']} "
          f"{lm_s['prefill_ms']:.2f} ms, {lm_s['prefill_tokens_per_s']:.0f} "
          f"tokens/s (bound {lm_s['prefill_bound_ms']:.2f} ms); decode "
          f"{lm_s['decode_ms_per_step']:.3f} ms a step, "
          f"{lm_s['decode_tokens_per_s']:.0f} tokens/s (bound "
          f"{lm_s['decode_bound_ms']:.3f} ms); 1 x {LM_LONG} prefill "
          f"{lm_s['long']['ms']:.1f} ms; peak {lm_s['peak_gb']:.3f} GB")
    print("phase 6b: " + json.dumps(lm_s))
    tr = training["8b"]
    print(f"LM train {tr['arch']} bf16 {tr['batch']}: warm step "
          f"{tr['warm_ms']:.1f} ms, {tr['tokens_per_s']:.0f} tokens/s "
          f"(bound {tr['bound_ms']:.1f} ms), optimizer "
          f"{tr['optimizer_ms']:.1f} ms, peak {tr['peak_gb']:.2f} GB; "
          f"crash-resume bitwise over {training['8c']['steps_run']}; "
          f"phase 8 {training['seconds']:.1f} s")
    g9 = gnn["9a"]
    print(f"GNN train sampled PNA {g9['batch']['seeds']} seeds "
          f"{g9['batch']['fanout']}: warm step {g9['warm_ms']:.2f} ms + "
          f"sampling {g9['sample_ms']:.2f} ms, {g9['seeds_per_s']:.0f} "
          f"seeds/s (bound {g9['bound_ms']:.2f} ms), peak "
          f"{g9['peak_gb']:.2f} GB; molecule warm steps "
          + ", ".join(f"{k} {v['warm_ms']:.2f} ms"
                      for k, v in gnn["9b"].items())
          + f"; phase 9 {gnn['seconds']:.1f} s")
    ra, rd = recsys["10a"], recsys["10d"]["ranks"]
    print(f"recsys {RECSYS_ARCH} full width: train_batch "
          f"{ra['train_batch']['warm_ms']:.2f} ms a step, "
          f"{ra['train_batch']['examples_per_s']:.0f} examples/s; serve_p99 "
          f"p99 {ra['serve_p99']['p99_ms']:.3f} ms; serve_bulk "
          f"{ra['serve_bulk']['rows_per_s']:.0f} rows/s; retrieval_cand "
          f"{ra['retrieval_cand']['ms']:.4f} ms; pipeline over {RANKS} "
          f"ranks {max(r['pipeline']['ms'] for r in rd):.1f} ms, "
          f"compressed_psum {max(r['compressed_psum']['ms'] for r in rd):.1f}"
          f" ms; phase 10 {recsys['seconds']:.1f} s")
    print("paper engine on the card: " + "; ".join(
        f"{k} {v['n_nodes']} nodes {v['wall_ms']:.2f} ms "
        f"{max(v['iterations'])} trips {v['gteps']:.3f} GTEPS (bound "
        f"{v['bound_ms']:.3f} ms)" for k, v in paper["cells"].items())
          + f"; phase 11 {paper['seconds']:.1f} s")
    print("phase 12: " + json.dumps({k: v for k, v in mesh_lm.items()
                                     if k != "ranks"}))
    print("phase 13: " + json.dumps(mesh_cells))
    print("phase 14: " + json.dumps(mesh_train))
    print("phase 15: " + json.dumps(mesh_moe))
    mark(None)
    print("phase seconds: " + json.dumps(phase_s))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
