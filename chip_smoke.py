#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hm_retrieval_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--seed 0] [--repeats 5]

Phases, each of which must pass (a failure raises and exits non-zero):

1. Device: print the card's name and power limit (nvidia-smi), build the
   CUDA kernels from csrc/ with nvcc, print the build time.
2. The exact passes' kernels 1, 2 and 8 against their plain PyTorch
   versions on the card, over the 105,542-row H&M catalog padded to L,
   E=128, bf16, at B = 1, 16, 37, 128 query rows and L=2048 (k=1000) and
   L=1024 (k=100), kernel 2 on the thresholds of its own round 1, kernel 8
   at +inf / -1 and then on its own first round's; n_valid = 105,542 ends
   inside a segment of the split chunk walk:
   (a) integer-valued inputs in [-4, 4]: exact in bf16 and in fp32 sums,
       with heavy ties; outputs must be bit-identical;
   (b) random normal inputs: values within TOL*max(1,|v|), ids equal
       wherever the competing scores differ by more.
   Each (L, B) prints the kernels' launch shape (cluster size, warps and
   warp groups per block, ring stages, shared bytes, registers, spilled
   bytes, the launch's clusters and the clusters of 1, 2, 4 and 8 blocks
   resident at once), and the cluster size must be the largest whose whole
   grid is resident at once. Kernels 1-2 are timed at B = 1, 16,
   128, L=2048, beside their bound: device time of 50 launches replayed
   from one CUDA graph ("ms"), and of 50 back-to-back launches by CUDA
   events ("events_ms", which includes the wrappers' host time where that
   is longer). Then exact_topk at B=128 against a
   plain full-score reference (fp32 product of the same bf16 operands,
   stable sort), with timings. Last, kernels 1, 2 and 8 at E = 64 and 256
   (the instantiation that reads the query's fragments from shared memory)
   on integer inputs, bit-identical.
3. Serving at full H&M width: 1,371,980 customers and 105,542 articles,
   E=128, towers [256], k=1000, random weights from --seed. The catalog is
   embedded with collect_catalog_device, indexed with BruteForceIndex("auto"),
   which must resolve to the kernels, everything is saved and loaded back
   through RetrievalService.load(device="cuda"), and string requests of
   B = 1, 16, 128, 1024 customers (a few OOV) are answered. Answers must
   hold 1000 distinct articles and agree with the plain reference; both
   kernel launch counters must grow during this phase.
4. The int8 single-pass kernels against their plain versions on the card,
   on the same catalog as int8 codes padded to 131,072 rows, E=128, at the
   served (fold F, bins L, batch B) of each plan: (1, 2048, 1024),
   (2, 2048, 128), (8, 2048, 16), (8, 2048, 1) and (16, 512, 16); the raw
   (global-scale) pass (kernel 5) over the full chunks of real rows. All
   three (instances of bin_max2.cu's template: kernels 3-4 of its per-row
   int8 kind, kernel 5 of its raw kind) print their launch shape at each
   plan under phase 2's cluster rule. Integer-valued queries must give
   bit-identical outputs, normal ones values within TOL; each kernel is
   timed at each plan by graph ("ms") and by events ("events_ms"). Kernels
   3-5 also run at E = 64, 256 and 576 (the instantiation that reads the
   query from shared memory) on integer inputs, bit-identical. Then
   quantized_topk as a whole against a matmul + topk yardstick.
5. Quantized serving at full H&M width, on phase 3's embedded catalog and
   model: QuantizedIndex(method="auto") must resolve to the kernels with
   2000 survivors, and its build on the card must equal the host
   quantization bit for bit; per-row and global-scale indices are saved and loaded
   back through RetrievalService.load(device="cuda") and answer the same
   requests (B = 1, 16, 128, 1024). The per-row index must launch the fold
   pass once a batch at B <= 128 and the no-fold pass at B = 1024, the
   global-scale index the raw pass once a batch at every B. Answers
   hold 1000 distinct articles, and equal the same driver run with the
   plain passes (fp32 rescore included) wherever the two passes' survivors
   agree; where they differ, only between scores within TOL. Recall
   against the exact fp32 top-1000 is printed, not held to a limit.
6. The rounds kernels against their plain versions on the card, at the
   served shapes: the int8 first and refinement rounds (kernels 6-7, the
   int8 instances of bin_max2.cu's template) over random int8 codes of the
   106,496 rows of the chunks that hold a valid row, as quantized_topk
   streams them (105,542 valid, a -inf bias on 1% of them), at B = 1, 16,
   37, 128 and L = 2048 (k=1000) and L = 1024 (k=100), the refinement
   round on the thresholds the first revealed, each (L, B) printing the
   kernels' launch shape under phase 2's cluster rule; timed at B = 1, 16,
   128, L = 2048, by graph and by events; and at E = 64 and 256 on
   integer inputs. The single-keep pass on the bf16 catalog at L=2048 and
   L=512, at +inf thresholds and at those of a previous round.
   Integer-valued queries must give bit-identical outputs, normal ones
   values within TOL. Then
   the drivers: quantized_topk with 8 rounds at B = 128 and 1024 (2000
   survivors) must answer as its 128-row blocks answer alone, and each
   block whose stop rule held within 8 rounds the exact top-2000 of the
   dequantized scores; exact_topk(keep_per_bin=1) at k = 100 and 1000 must
   equal the same driver on the plain pass, and the exact top-k where its
   rounds < 8; exact_topk(lockstep=True) at B=1024, k=1000 must return the
   per-block driver's ids. Timings beside a matmul + topk yardstick.
7. Quantized serving with the rounds (pallas_rounds=8) at full H&M width,
   on phase 3's catalog and model: per-row and global-scale indices
   (B = 1, 16, 128, 1024 each), saved and loaded back through
   RetrievalService.load(device="cuda"). The int8 rounds kernels must
   launch, the single-pass kernels must not. On every row the survivors
   equal the plain passes' survivors: values within TOL, ids differing only
   between dequantized scores within 2*TOL. Answers hold 1000 distinct
   articles and equal the same driver run with the plain passes (fp32
   rescore included) wherever the survivors agree. Rounds per batch and
   recall against the exact fp32 top-1000, beside phase 5's single-pass
   recall, are printed, not held to a limit.
8. Widths the kernels do not take as they are (phase_widths): over 20,000
   rows of integer-valued embeddings, BruteForceIndex("auto") (k=1000) and
   QuantizedIndex (k=100) with one pass and with 8 rounds at E = 8 and 100
   run the kernels on E padded to 16 and 112 and answer bit-identically to
   the same indices on the CPU; at E = 520 the exact index routes to
   "full" and the rounds to "scan", the one pass runs its kernels at 528,
   and at E = 600 the one pass routes to "scan", each route with a log
   line. The one pass's launch shapes at padded E = 528 and 576 are
   printed.
9. Training at full H&M width (bench.py's model from the port's classes:
   customer_id 1,371,980 x 128, article_id 105,542 x 128, product types
   130 x 16, colours 50 x 8, towers [256], joint 128, logQ from a
   Dirichlet(0.5) popularity with seed 0), B = 512, TrainingConfig's
   defaults (sparse Adagrad, lr 0.05). No TPU kernel lies on this path, and
   the bin-max kernels' counts must stay 0 through it. Synthetic shards
   (numpy, shard_*.npz and the manifest) hold a learnable stream: 4096
   customers, each buying a favourite article 80% of the time. Then:
   (a) at 5,000 customers and 2,000 articles, each path's 3 card steps
       against the port's CPU steps from the same state and batches: the
       losses and every tensor of the state within rtol 1e-4 / atol 1e-5;
       before them, the card model's initial parameters must equal the CPU
       model's of the same seed bit for bit (both draw on the CPU);
   (b) each path through make_single_device_trainer and
       ShardDataset.iter_batches(shuffle) -> device_feed -> step: sparse
       Adagrad with and without a 16-long mean-pooled purchase history,
       dense Adagrad, dense Adam (lr 1e-3), 512 uniform negatives (dense
       Adagrad), and the chunked step at K = 8; 8 warm-up steps, one of them
       under torch.cuda.set_sync_debug_mode("error"), then 48 timed steps
       (CUDA events each); the same steps on batches already on the card
       (what the feed costs); 3 steps under torch.profiler (idle share,
       device operations a step, the top operations); every loss finite and
       the last five lower than the first five; on the sparse paths every
       untouched table and accumulator row bit-unchanged; the step's bound;
   (c) 3 sparse and 3 dense Adagrad steps replayed twice from one saved
       state at full width: every tensor and loss bit-identical;
   (d) 8 single sparse steps against one chunked call of the same 8 steps,
       on the same batches on the card, in turns over 8 rounds.
10. The modelling runner at full H&M width (phase_runner): phase 9's model
   (ks 10, 100, 1000; TrainingConfig's defaults: sparse Adagrad, lr 0.05,
   B = 512, test batches of 2048, candidate batches of 10,000, one epoch)
   from its schema, saved with Schema.save, and shards written with phase
   9's writer: 65,536 rows of the learnable stream to train on (128
   steps), the next 16,384 to test on (8 batches), and all 105,542
   articles with their side features; the same stream as a transactions
   CSV (t_dat, article_id: train rows over 45 days, test rows over the 7
   after, each article as its zero-padded 10-digit H&M id, which the
   schema's vocab holds as read back as an integer). Then:
   (a) modelling_runner(settings) on the card, counts from 0, with the
       default profiler window (steps 20-40): every recall finite and in
       [0, 1], recall@100 higher after the epoch than before, kernels 1-2
       launched inside evaluate and no other kernel, the checkpoint at
       step 128, the exported towers, the index artifact, and the
       profiler's Chrome trace holding the card's kernels; the training
       examples/s it logs include the profiler;
   (b) evaluation_runner(settings) from the checkpoint equals the runner's
       final recall exactly;
   (c) the restored parameters: the checkpoint's bytes, save and restore
       ms; build_index's wall ms, during which (and during
       collect_catalog_device, whose catalog stays on the card) every copy
       from the card to the host is recorded, and all of them together
       must move less than one candidate batch's embeddings; evaluate's
       wall ms and ms a batch, equal to the final recall again; the index's
       save ms; the card's idle share over one evaluate batch (profiler);
   (d) on the first two test batches, the exact index's answers against
       the same index with exact_topk's kernels swapped for their plain
       versions: values within TOL*max(1,|s|), ids swapped only between
       scores within it, equal recall counts;
   (e) the quantized family through build_index + evaluate, counts from
       0: which single-pass kernel launched and how often, and its recall
       beside the exact index's (a reading, not a gate); then, on the first
       two test batches, that kernel (3 or 4, at B = 2048) against its
       plain version on the inputs evaluate gives it: cells within TOL, ids
       differing only between scores within 2*TOL, the answers with the
       plain pass swapped in bit-equal wherever the two passes keep the
       same survivors, and equal recall counts.
   Each kernel's launches in (a) and (e) are added to its count on the
   kernels line.
11. The popularity baseline (phase_baseline) on phase 10's CSV and test
   shards: baseline_modelling_runner(settings) on the card; its static
   artifact must load through load_index as a StaticIndex on the card and
   hold the train rows' 1000 most popular articles counted directly (count
   descending, ties by first appearance; all 1000 in the vocab, so the
   zero-padded ids were read as integers), and its recall must equal the
   share of test rows among the top k. Its recall is printed beside phase
   10's trained model's.
12. The mesh-sharded index at full H&M width (phase_sharded), on phase 10's
   trained catalog (105,542 x 128) and the query tower's first test batch,
   k = 1000, make_mesh(1, 4, devices=[card] * 4): 26,386 rows a shard, the
   last with 2 pad rows. Counts from 0 over the main path:
   DistributedBruteForceIndex("pallas") (kernels 1-2 on [q | 1] against
   [emb | bias], E + 1 = 129 padded to 144) and DistributedQuantizedIndex
   ("pallas") with one pass (kernels 3-4, per-shard plans) and with
   pallas_rounds = 8 (kernels 6-7) at B = 1, 16, 128, 1024, each of whose
   kernels must launch; DistributedBruteForceIndex on a (2, 2) mesh at
   B = 37 (the query padding); RetrievalService.load(mesh,
   distributed_index=True) over phase 10's artifact answering 128
   customers; evaluation_runner(mesh, distributed_index=True). Then, at each
   B: the exact index against the same index on kernels 1-2's plain
   versions and against the single-device index (values within
   TOL*max(1,|s|), ids differing only between scores within TOL); each
   quantized index's per-shard survivors against the plain passes' (within
   TOL, ids only between pass scores within 2*TOL) and its answers
   bit-equal wherever every shard keeps the same survivors, its recall
   against the fp32 top 1000 no lower than the single-device index's by
   more than 0.005; every answer finite, without NaN, pad rows or repeats.
   The last shard's pad rows score exactly -inf through the bias column
   (fp32 of the bf16 operands) and kernel 1 over them returns no NaN and
   none of them. The (2, 2) mesh's answers against the (1, 4) mesh's, the
   sharded service's strings against the single-device service's, as
   above. The sharded artifact evaluation_runner saved holds 4 shard files
   and loads back; over every test batch its recall counts differ from the
   single-device index's by no more than the rows whose top k differ, and
   equal evaluation_runner's and phase 10's. Each index is timed at each B
   beside its single-device counterpart (CUDA events). Its launches are
   added to each kernel's count on the kernels line.
13. Training over a one-process mesh at full H&M width (phase 9's model,
   B = 512, lr 0.05; Adam as phase 9's check takes it), meshes of the one
   card repeated (make_mesh(D, S, devices=[card] * (D * S))); no TPU kernel
   lies on its training paths. Cut: depth only (5 held steps, 3 + 20 timed
   a path; one epoch in (c)).
   (a) each mesh path through make_mesh_trainer, against its single-device
       counterpart through make_single_device_trainer, both from one seed
       (initial states equal bit for bit): data-parallel dense Adagrad,
       dense Adam and 512 uniform negatives (the rows given to both) and
       sparse Adagrad at (4, 1); customer_id and article_id row-sharded,
       dense Adagrad at (2, 2), sparse at (2, 2) and (1, 4). Over 5
       batches, each mesh step starts from the single-device chain's state
       and must land within rtol 1e-4 / atol 1e-5 of its next state, losses
       within rtol 1e-5 (a free-running chain is a reading: a ReLU input
       within rounding of 0 can fall on either side); one step under
       set_sync_debug_mode("error"); two free-running replays of the 5 steps
       bit-identical; pad rows and every row no batch touched bit-unchanged;
       no NaN. make_sharded_lookup's "psum" and "all_to_all" over the
       sharded customer table equal table[ids] bit for bit, and a capacity
       of 1 gives NaN;
   (b) each mesh path's median step ms by CUDA events over 20 steps fed by
       device_feed(mesh=...), examples/s, device ms, idle share and
       operations a step under torch.profiler, peak memory, beside phase
       9's single-device rows of the same call;
   (c) modelling_runner over a (2, 2) mesh on phase 10's stream and schema
       with customer_id and article_id row-sharded and distributed_index,
       counts from 0: recall@10/100/1000 before and after beside phase
       10's, recall@100 rising, kernels 1-2 launched (per shard) and no
       other kernel, examples/s of the epoch (trace off), the exported
       towers in phase 10's unpadded shapes; evaluation_runner over the
       mesh equal to final; a resumed run continuing the step count from
       the checkpoint; the checkpoint's bytes, save and restore ms. Its
       launches are added to each kernel's count on the kernels line.
14. Several processes on the one card (phase_processes): two ranks spawned
   with torch.multiprocessing, each joining a gloo group through
   initialize_multihost (a file:// rendezvous; NCCL refuses two ranks on one
   device) on cuda:0, each passing make_mesh its own two cells; the parent
   waits PROC_TIMEOUT seconds and kills both ranks past it, and a rank that
   fails or writes no result fails the phase. Phase 10's width and weights.
   Each rank's launches are counted from 0 around (a) and (b) and added,
   over both ranks, to the kernels line. Cut: depth only (3 held steps a
   path; sparse: 3-step replays, 5 timed, 2 profiled; dense: 1-step
   replays, 1 timed, none profiled: cut from 10 / 3 and 2 / 1 for phase
   18's time).
   (a) phase 12's exact and one-pass sharded indices over a (1, 4) mesh,
       rank r holding shards 2r and 2r + 1 (kernels 1-2, 3-4 per shard),
       at B = 1, 16, 128, 1024: values and ids bit-identical to phase 12's
       one-process S = 4 indices on the same queries, on both ranks; ms a
       serve by CUDA events beside phase 12's, the exchange's bytes and ms;
   (b) evaluation_runner over a (2, 2) mesh, data row r on rank r, over
       phase 10's checkpoint and stream (1024 test rows a rank a batch):
       recall@10/100/1000 on both ranks equal to phase 10's, and with
       distributed_index equal to the one-process (2, 2) runner's;
       to_local() of the collectively saved sharded index gives both ranks
       the same catalog;
   (c) phase 13's data-parallel sparse and dense Adagrad at (4, 1) (data
       rows 0-1 on rank 0, each rank fed its 256 rows) and row-sharded
       sparse at (1, 4) (the model axis over the ranks, both fed the whole
       batch): each step from the single-device chain's state within rtol
       1e-4 / atol 1e-5, losses within 1e-6 relative, the replicated state
       bit-identical across the ranks after every step, replays
       bit-identical, untouched and pad rows unchanged; step ms by CUDA
       events beside phase 13's, 1-3 steps under torch.profiler on rank 0,
       the bytes each step sends through the group, peak GB per rank.
   (d) modelling_runner over a (2, 2) mesh, data row r on rank r, both id
       tables row-sharded and the sharded index, on phase 13's schema and
       phase 10's stream (one epoch, 512 / 2 rows a rank a step): the same
       recall on both ranks, before any step phase 13's initial recall
       exactly, recall@100 rising; its final recall beside phase 13's and
       beside phase 13's run reshuffled (shuffle_buffer_size 8192), since
       the ranks' own batch order moves it;
       the group's checkpoint restored by one process over a (2, 2) mesh
       gives the group's final recall, and phase 13's one-process checkpoint
       restored by the group its resumed run's; the group's index loads in
       one process.
15. The five stages through the port alone, from raw CSVs (phase_pipeline):
   the port's generate_hm_like_csvs at H&M width (1,371,980 customers,
   105,542 articles, 130 product types; 3,000,000 transactions, cut from
   H&M's 31.8M for time), then etl_runner, build_schema_runner and
   shard_writer_runner with .npz splits (the card's machine has no
   pyarrow), a 16-long purchase history, hm_schema's widths with every
   vocab built by the schema stage, the history (sharing article_id's
   vocab) and the standardised age as query features, logQ on:
   (a) pandas and pyarrow absent from sys.modules after the three stages;
       each manifest's num_rows the split's rows; one candidate row per
       article seen; exp(logQ) over the present ids summing to 1 within
       1e-5;
   (b) the three stages again, streamed (etl_chunk_rows, schema_stream_rows
       and shard_stream_rows a quarter of the transactions): every npz
       array of every shard equal by sha256 (dtype and shape included) to
       the in-memory run's, the vocabs and logQ equal;
   (c) modelling_runner (one epoch at B = 2048, ks 10, 100, 1000, counts
       from 0): recall@100 rising, kernels 1-2 launched inside evaluate and
       no other kernel, then baseline_modelling_runner over the CSV, its
       recall printed beside the model's. A pipeline line gives each stage's
       seconds in memory and streamed, rows, vocab sizes, shard bytes, peak
       host RSS and the recalls. Its launches join the kernels line.

16. The rest of the host surface (phase_host_surface): H&M-shaped CSVs
   written with numpy (write_hm_csvs: the file names, columns and date window
   examples/run_hm.py reads; 105,542 articles with zero-padded 10-digit ids,
   131 product types, 19 groups, 50 colours, 250 departments, 1,371,980
   64-hex customers, 3,000,000 transactions over 2019-09-20..2020-09-21, cut
   from H&M's 31.8M for time), then three in-process calls of
   examples/run_hm_torch.py's main, counts from 0:
   (a) --stages etl,schema,shards --history 16 --sample 0.5 --epochs 2
       with the three streaming flags at a quarter of the sampled rows (the
       schema snapshots two epochs);
   (b) --stages model,baseline --epochs 1: recall@100 rising, kernels 1-2
       launched inside evaluate and no other kernel;
   (c) --stages model --epochs 1 --resume: the epochs override (2 -> 1)
       logged, its first evaluation (b)'s last, and its last checkpoint at
       twice (b)'s step (one epoch after (b)'s one; cut from two for
       time);
   before (b) and (c), each with --export-savedmodel where tensorflow cannot
   be imported (the card's machine): ImportError naming it in under 5 s,
   no step and no checkpoint written. Then (a)'s test split through
   dataframe_to_tfrecords (100,000 rows a file) and import_tfrecords, every
   shard array equal to a direct ShardWriter write, and
   export_shards_to_tfrecords then a second import, equal again (records/s
   each way, bytes, the CRC's seconds); and the NaN checks on the card: a
   NaN made in forward and one made only in backward raise
   FloatingPointError under enable_debug_checks, a sparse step at B = 512
   and exact_topk at B = 128 run clean with the bits they give without the
   checks, and after disable_debug_checks the NaN passes. A host_surface
   line gives the readings. Its launches join the kernels line.

17. One process over several distinct devices (phase_several_devices; run
   after phase 14, on phase 10's data): meshes whose cells are the card
   and the host CPU, make_mesh(..., devices=[card, "cpu"]), the card first,
   so every replica, row shard, gradient and row that crosses between them
   is a real copy (autograd's included). Phase 13's widths (B = 512). Cut:
   depth only (5 held steps; replays of 1 step on the dense paths, 5 on
   the sparse ones; one test batch of 2048 rows in (b)).
   (a) through make_mesh_trainer, each step from the single-device chain's
       state within rtol 1e-4 / atol 1e-5, replays bit-identical, pad and
       untouched rows unchanged, as phase 13 (a): data-parallel dense and
       sparse Adagrad at (2, 1) (data shard 1 on the host), row-sharded
       dense and sparse at (1, 2) (customer_id and article_id, shard 1 on
       the host); each path prints the bytes its step 0 copied between the
       devices (a dispatch mode over _to_copy and copy_), where each
       state tensor and table shard lies, checked against its cell
       (replicated on the card, shard s on column s's device), and the
       median host-clock step ms (not a speed figure: the host cell sets
       the pace); make_sharded_lookup's strategies across the devices bit
       for bit;
   (b) modelling_runner over (1, 2) with both id tables row-sharded and
       distributed_index on phase 13 (c)'s schema and phase 10's stream (one
       epoch; the first 2048 test rows, as the host's shard of the index
       runs its plain passes), counts from 0: recall@100 rising, kernels 1-2
       launched (the card's shard) and no other kernel; evaluation_runner
       from its checkpoint over (1, 2) of the card repeated on every test
       row, beside phase 13's final recall; then the checkpoint restored
       into a fresh mesh state (each shard on its cell), one step, a save,
       one more step, against a second fresh state restored from that save
       taking the same step: every tensor bit-identical, on the same device;
   (c) the exact, one-pass and 8-round sharded indices over (1, 2) on phase
       10's trained catalog at B = 1 and 1024, counts from 0: kernels 1-4
       and 6-7 launched by the card's shard, the host's running the plain
       passes; answers held to phase 12's rule (exact against its plain
       passes and the single-device index, quantized survivors per shard
       against the plain passes', recall no lower than the single-device
       index's by more than 0.005).
   Where the machine shows two cards or more, the same (a)-(c) over every
   card (make_mesh()'s cells, cuda:0..n-1, n the largest power of two of
   them, so that each axis divides B): (a) at (n, 1), (1, n) and, with
   4 cards, (2, 2), each path also timed over 20 steps by CUDA events
   through device_feed(mesh=...), profiled (device ms and idle share a
   card) with the peak GB a card, and replayed on the card repeated to say
   whether the bits equal the same-device mesh's; (b) and (c) over (1, n).
   Its launches join the kernels line.

18. Ranks of a process group, each over several distinct devices
   (phase_ranks_several_devices; run after phase 17, on phase 10's data):
   two ranks spawned as phase 14's (torch.multiprocessing, a file://
   rendezvous, killed past 480 s; a rank that fails or writes nothing
   fails the phase), gloo on the one card, each calling make_mesh(...,
   devices=[card, "cpu"]), so the grid in rank order is card, host, card,
   host and every exchange crosses a device boundary inside a rank as well
   as between ranks. Phase 13's widths, B = 512. The references run in
   this process over the same grid (make_mesh(D, S, devices=[card, "cpu"]
   * 2); on four cards each rank's first card, cuda:0 and cuda:2), on the
   ranks' host thread count. Cut: depth only (held steps: 3
   sparse, 1 dense, each replayed twice; 5 host-clock steps on the sparse
   paths, none on the dense ones; one test batch of 2048 rows in (b)).
   (a) through make_mesh_trainer: (2, 2) row-sharded sparse and dense
       Adagrad (data row r on rank r, the model axis across the card and
       the host), (4, 1) data-parallel sparse and dense Adagrad (rank r
       rows 2r on the card, 2r + 1 on the host) and (1, 4) row-sharded
       sparse (rank r columns 2r and 2r + 1, one data row over both ranks).
       Each held step from the single-device chain's state within rtol
       1e-4 / atol 1e-5, the replicated state bit-identical across the
       ranks after every step, replays bit-identical, pad and untouched
       rows unchanged, each state tensor and table shard on its cell, and
       every tensor after every held step bit-identical to the one-process
       mesh's; each path prints the bytes the group exchanges and the bytes
       copied between devices in a step and the median host-clock step ms
       (not a speed figure: the host cells set the pace);
   (b) modelling_runner over (2, 2), data row r on rank r, both id tables
       row-sharded, distributed_index, on phase 13 (c)'s schema and phase
       10's stream (one epoch; the first 2048 test rows), counts from 0:
       the same recall on both ranks, recall@100 rising, kernels 1-2
       launched (the card's shards) and no other kernel; the group's
       checkpoint restored by this process over the same grid gives the
       group's final recall, and a step from it, on the ranks' first rows,
       every tensor bit-identical to the ranks' step from it;
   (c) the exact, one-pass and 8-round sharded indices over (1, 4), rank r
       holding shards 2r (card) and 2r + 1 (host), on phase 10's trained
       catalog at B = 1 and 1024 (the one-pass kernel 3 runs only past
       B = 128), counts from 0: kernels 1-4 and 6-7 launched on each rank
       (its card's shard), the answers bit-identical to this process's
       index over the same grid, which phase 17 (c)'s code holds to phase
       12's rule.
   Where the machine shows four cards (a call given four chips): the same
   over two NCCL ranks of two cards each (initialize_multihost() then
   make_mesh()), (a) also timed over 20 steps by CUDA events with the peak
   GB a card, the references over the four cards; then phase 14's (a) and
   (c) over four NCCL ranks, a card each, with the exchange's bytes and ms.
   Both ranks' (b) and (c) launches join the kernels line.

Output: per-phase JSON lines and each phase's seconds, then the card's name
and power limit, the
{"kernels": [...]} line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, when CUDA is not available.
"""

import argparse
import contextlib
import dataclasses
import itertools
import json
import logging
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
N_CUSTOMERS = 1_371_980
N_ARTICLES = 105_542
N_PRODUCT_TYPES = 130
N_COLOURS = 50
E = 128
Q_BLOCK = 128
SERVE_K = 1000
SERVE_BATCHES = (1, 16, 128, 1024)
KERNEL_BATCHES = (1, 16, 37, 128)  # B of phase 2's kernel checks
TIMED_BATCHES = (1, 16, 128)  # B at which phase 2 times kernels 1-2
TOL = 1e-4  # relative to max(1, |score|): fp32 summation order
N_PAD_Q = 131_072  # the H&M catalog padded to the quantized index's chunk
# (fold F, bins L, batch B) of the single-pass plans at the served shapes:
# k_over = 2000 at B = 1024, 128, <= 16, and k <= 100 at any B
QUANT_PLANS = ((1, 2048, 1024), (2, 2048, 128), (8, 2048, 16), (8, 2048, 1),
               (16, 512, 16))
SURVIVORS = 2000  # k_over of the served quantized index
MAX_ROUNDS = 8  # the drivers' cap on passes per query block
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak, published


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps):
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back calls
    (CUDA events, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps):
    """Mean device milliseconds of ``fn`` over ``reps`` calls captured in one
    CUDA graph and replayed 5 times, after a warm-up on a side stream: the
    kernels' own time, without the host's cost of launching them (which
    back-to-back timing by ``cuda_ms`` includes once it exceeds the
    kernel's)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def pass_bound_ms(B, n_pad, L, thresholds, outputs=4):
    """Least time of one streaming pass: bytes (query block, catalog, the
    (B, L) outputs, plus two threshold inputs) over HBM bandwidth, or the
    product's operations over the bf16 peak, whichever is larger."""
    nbytes = B * E * 2 + n_pad * E * 2 + outputs * B * L * 4
    if thresholds:
        nbytes += 2 * B * L * 4
    return roofline_ms(nbytes, 2 * B * n_pad * E)


def roofline_ms(nbytes, ops):
    """(ms, what bounds it): the larger of bytes over HBM bandwidth and
    bf16 operations over the tensor-core peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def compare_ranked(got_v, got_i, want_v, want_i, scores, gap=2 * TOL):
    """Values within TOL; id mismatches only between scores within ``gap``
    (relative to max(1, |score|)). Returns (max |value difference| over
    finite slots, id mismatches)."""
    finite = torch.isfinite(want_v)
    require(
        torch.equal(torch.isfinite(got_v), finite), "unfilled slots differ"
    )
    err = (got_v - want_v)[finite].abs()
    scale = want_v[finite].abs().clamp_min(1.0)
    require(bool((err <= TOL * scale).all()), "values outside tolerance")
    diff = got_i != want_i
    require(not bool((diff & ~finite).any()), "unfilled ids differ")
    rows = diff.nonzero()[:, 0]
    s_got = scores[rows, got_i[diff].long()]
    s_want = scores[rows, want_i[diff].long()]
    gap_ok = (s_got - s_want).abs() <= gap * s_want.abs().clamp_min(1.0)
    require(bool(gap_ok.all()), "ids differ between well-separated scores")
    return float(err.max()) if err.numel() else 0.0, int(diff.sum())


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    from hm_retrieval_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = [
        line.strip()
        for log in _build.build_logs.values()
        for line in log.splitlines()
        if "entry function" in line or "registers" in line or "spill" in line
    ]
    emit({"build": {"seconds": seconds, "sources": _build.sources(),
                    "ptxas": ptxas}})
    return card


def phase_kernels(gen, dev):
    """Kernels 1, 2 and 8 against their plain versions at every (B, L) of
    KERNEL_BATCHES x (2048, 1024); kernels 1-2 timed at TIMED_BATCHES."""
    from hm_retrieval_tpu_torch.ops import bin_topk as bt

    names = ("bin_max2_first_round", "bin_max2_round", "bin_max_round")
    stats = {n: {"max_abs_err": 0.0, "id_mismatches": 0} for n in names}
    for n in names[:2]:
        stats[n]["shapes"] = []
    topk_rows = []
    for k, L in ((SERVE_K, 2048), (100, 1024)):
        require(bt.default_bins(k) == L, f"default_bins({k}) != {L}")
        n_pad = -(-N_ARTICLES // L) * L
        for B in KERNEL_BATCHES:
            infos = {n: bt.launch_info(B, E, L, keep=1 if n == names[2] else 2,
                                       threshold=n != names[0], device=dev)
                     for n in names}
            check_clusters(infos, L, B)
        inf_s = torch.full((Q_BLOCK, L), float("inf"), device=dev)
        inf_i = torch.full((Q_BLOCK, L), -1, dtype=torch.int32, device=dev)
        for kind in ("integer", "normal"):
            q_all = random_rows(gen, dev, kind, Q_BLOCK)
            c_pad = torch.zeros(n_pad, E, dtype=torch.bfloat16, device=dev)
            c_pad[:N_ARTICLES] = random_rows(gen, dev, kind, N_ARTICLES)
            for B in KERNEL_BATCHES:
                q = q_all[:B]
                k1 = bt.bin_max2_first_round(q, c_pad, L, N_ARTICLES)
                p1 = bt.bin_max2_plain(q, c_pad, L, N_ARTICLES)
                # each chain refines with thresholds from its own round 1
                k2 = bt.bin_max2_round(q, c_pad, k1[2], k1[3], L, N_ARTICLES)
                p2 = bt.bin_max2_plain(q, c_pad, L, N_ARTICLES, p1[2], p1[3])
                k8 = bt.bin_max_round(q, c_pad, inf_s[:B], inf_i[:B], L,
                                      N_ARTICLES)
                p8 = bt.bin_max_plain(q, c_pad, inf_s[:B], inf_i[:B], L,
                                      N_ARTICLES)
                k8r = bt.bin_max_round(q, c_pad, *k8, L, N_ARTICLES)
                p8r = bt.bin_max_plain(q, c_pad, *p8, L, N_ARTICLES)
                torch.cuda.synchronize()
                for name, got, want in ((names[0], k1, p1), (names[1], k2, p2),
                                        (names[2], k8, p8),
                                        (names[2], k8r, p8r)):
                    hold_cells(stats[name], f"{name} L={L} B={B}", kind, got,
                               want, lambda: bt.plain_scores(q, c_pad))
                emit({"kernel_check": {"L": L, "B": B, "inputs": kind,
                                       "ok": True}})
                if kind != "normal" or L != 2048 or B not in TIMED_BATCHES:
                    continue
                # the served configuration (k=1000): times beside the bound
                for name, thr, plain in ((names[0], (), ()),
                                         (names[1], k1[2:], p1[2:])):
                    bound, by = pass_bound_ms(B, n_pad, L, bool(thr))

                    def launch():
                        return getattr(bt, name)(q, c_pad, *thr, L,
                                                 N_ARTICLES)

                    row = {
                        "L": L, "B": B, "rows": n_pad,
                        "ms": graph_ms(launch, 50),
                        "events_ms": cuda_ms(launch, 50),
                        "plain_ms": cuda_ms(lambda: bt.bin_max2_plain(
                            q, c_pad, L, N_ARTICLES, *plain), 5),
                        "bound_ms": bound, "bound_by": by,
                    }
                    stats[name]["shapes"].append(row)
                    if B == Q_BLOCK:
                        stats[name].update({key: row[key] for key in (
                            "ms", "events_ms", "plain_ms", "bound_ms",
                            "bound_by")})
            if kind != "normal":
                continue
            # exact_topk as a whole against the plain full-score reference
            q = q_all
            cand = c_pad[:N_ARTICLES].float()
            v, i, rounds = bt.exact_topk(q.float(), cand, k, L=L)
            cb = c_pad[:N_ARTICLES]

            def reference():
                s = bt.plain_scores(q, cb)
                sv, order = torch.sort(s, dim=1, descending=True, stable=True)
                return s, sv[:, :k], order[:, :k]

            scores, rv, ri = reference()
            err, mism = compare_ranked(v, i, rv, ri, scores)
            topk_rows.append({
                "k": k, "L": L, "B": Q_BLOCK, "N": N_ARTICLES, "E": E,
                "rounds": rounds, "max_abs_err": err, "id_mismatches": mism,
                "ms": cuda_ms(lambda: bt.exact_topk(q.float(), cand, k, L=L), 10),
                "plain_ms": cuda_ms(reference, 5),
                "yardstick_ms": cuda_ms(
                    lambda: torch.topk(torch.matmul(q, cb.T).float(), k), 10
                ),
                "yardstick": "torch.matmul (bf16) + torch.topk over (B, N)",
            })
    emit({"exact_topk": topk_rows})
    # the other instantiation (A fragments read from shared memory), at
    # widths other than E = 128, on integer inputs
    for width in (64, 256):
        L, n_pad, n_valid, B = 1024, 16384, 16000, 37
        q = torch.randint(-4, 5, (B, width), generator=gen,
                          device=dev).to(torch.bfloat16)
        c_pad = torch.randint(-4, 5, (n_pad, width), generator=gen,
                              device=dev).to(torch.bfloat16)
        inf_s = torch.full((B, L), float("inf"), device=dev)
        inf_i = torch.full((B, L), -1, dtype=torch.int32, device=dev)
        k1 = bt.bin_max2_first_round(q, c_pad, L, n_valid)
        p1 = bt.bin_max2_plain(q, c_pad, L, n_valid)
        k8 = bt.bin_max_round(q, c_pad, inf_s, inf_i, L, n_valid)
        p8 = bt.bin_max_plain(q, c_pad, inf_s, inf_i, L, n_valid)
        checks = ((names[0], k1, p1),
                  (names[1], bt.bin_max2_round(q, c_pad, k1[2], k1[3], L,
                                               n_valid),
                   bt.bin_max2_plain(q, c_pad, L, n_valid, p1[2], p1[3])),
                  (names[2], k8, p8))
        torch.cuda.synchronize()
        for name, got, want in checks:
            hold_cells(stats[name], f"{name} E={width}", "integer", got, want,
                       None)
        emit({"kernel_check": {"E": width, "L": L, "B": B,
                               "inputs": "integer", "ok": True}})
    return stats


def check_clusters(infos, L, B, **where):
    """Each kernel's launch shape at (L, B) holds the launcher's rule: the
    largest cluster size whose whole grid the card holds at once. Prints
    the shapes as one kernel_launch line, with ``where`` (e.g. the fold)."""
    for n, info in infos.items():
        fits = [c for c in (2, 4, 8)
                if info["resident"][c] >= info["clusters"]]
        require(info["cluster"] == max(fits, default=1),
                f"{n} L={L} B={B}: cluster {info['cluster']}, "
                f"resident {info['resident']}")
    emit({"kernel_launch": {"L": L, "B": B, **where, **infos}})


def hm_schema(n_customers=N_CUSTOMERS, n_articles=N_ARTICLES, logq=None,
              article_vocab=None):
    from hm_retrieval_tpu_torch.schema import (
        Feature, ModelConfig, Schema, TrainingConfig,
    )

    def vocab(prefix, n):
        return np.array([f"{prefix}{i:07d}" for i in range(n)])

    if article_vocab is None:
        article_vocab = vocab("a", n_articles)
    features = [
        Feature("customer_id", "categorical", "query", embedding_size=E,
                vocab=vocab("c", n_customers)),
        Feature("article_id", "categorical", "candidate", embedding_size=E,
                vocab=article_vocab),
        Feature("product_type_name", "categorical", "candidate",
                embedding_size=16, vocab=vocab("pt", N_PRODUCT_TYPES)),
        Feature("colour_group_name", "categorical", "candidate",
                embedding_size=8, vocab=vocab("col", N_COLOURS)),
    ]
    config = ModelConfig(E, ks=[10, 100, SERVE_K], query_tower_units=[256],
                         candidate_tower_units=[256])
    return Schema(features, config, TrainingConfig(), logq=logq)


def phase_serving(seed, repeats, dev, workdir):
    from hm_retrieval_tpu_torch.indices.brute_force import BruteForceIndex
    from hm_retrieval_tpu_torch.indices.builder import collect_catalog_device
    from hm_retrieval_tpu_torch.models import TwoTowerModel
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.runners.checkpoint import export_model
    from hm_retrieval_tpu_torch.serving import RetrievalService

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    schema = hm_schema()
    model = TwoTowerModel.create_from_schema(schema, device=dev).init_params(seed)
    tc = schema.training_config
    article_ids = np.arange(1, N_ARTICLES + 1, dtype=np.int32)
    product_type = rng.integers(1, N_PRODUCT_TYPES + 1, N_ARTICLES).astype(np.int32)
    colour = rng.integers(1, N_COLOURS + 1, N_ARTICLES).astype(np.int32)
    bs = tc.candidate_batch_size
    batches = (
        {"article_id": article_ids[s:s + bs],
         "product_type_name": product_type[s:s + bs],
         "colour_group_name": colour[s:s + bs]}
        for s in range(0, N_ARTICLES, bs)
    )

    @torch.no_grad()
    def embed(batch):
        return model.candidate_forward(
            {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        )

    ids, emb = collect_catalog_device("article_id", embed, batches, bs)
    index = BruteForceIndex(max(schema.model_config.ks), ids, emb,
                            method="auto", device=dev)
    require(index.method == "pallas", f"auto resolved to {index.method!r}")
    schema.save(str(workdir / "schema"))
    export_model(model, str(workdir / "model"))
    index.save(str(workdir / "index"))
    svc = RetrievalService.load(str(workdir / "schema"), str(workdir / "model"),
                                str(workdir / "index"), device=dev)
    require(svc.index.method == "pallas" and svc.index._engine == "pallas",
            "the loaded index does not run the kernels")
    emit({"serving_setup": {"seconds": time.perf_counter() - t0,
                            "catalog": list(emb.shape),
                            "index_method": svc.index.method}})

    customers = schema.feature("customer_id").vocab
    requests = {}
    for B in SERVE_BATCHES:
        names = list(rng.choice(customers, B))
        for j in range(min(B // 8, 3)):  # a few OOV customers
            names[j * 5 % B] = f"unknown-{j}"
        requests[B] = {"customer_id": names}

    # --- the main path: counts from 0, served requests only -------------
    bt.reset_launches()
    rows, answers = [], {}
    for B in SERVE_BATCHES:
        before = dict(bt.LAUNCHES)
        svc.retrieve(requests[B])  # warm-up (first call builds the lookup)
        times = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            answers[B] = svc.retrieve(requests[B])
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        per_batch = {n: (bt.LAUNCHES[n] - before[n]) / (repeats + 1)
                     for n in bt.LAUNCHES}
        rows.append({"B": B, "median_ms": statistics.median(times),
                     "min_ms": min(times), "max_ms": max(times),
                     "launches_per_batch": per_batch})
    launches = dict(bt.LAUNCHES)
    # ---------------------------------------------------------------------
    require(launches["bin_max2_first_round"] > 0
            and launches["bin_max2_round"] > 0
            and launches["bin_max_round"] == 0,
            f"the exact path launched {launches}")

    article_vocab = set(schema.feature("article_id").vocab.tolist())
    emb_real = svc.index.embeddings[: svc.index.num_candidates]
    cb = emb_real.to(torch.bfloat16)
    art_row = {f"a{i:07d}": i for i in range(N_ARTICLES)}  # id i+1 = row i
    for row in rows:
        B = row["B"]
        got = answers[B]
        require(len(got) == B, f"B={B}: {len(got)} answers")
        for ans in got:
            require(len(ans) == SERVE_K and len(set(ans)) == SERVE_K,
                    f"B={B}: an answer is not {SERVE_K} distinct articles")
            require(set(ans) <= article_vocab, f"B={B}: unknown article")
        with torch.no_grad():
            q = svc.embed(svc.encode_query(requests[B]))
        scores = bt.plain_scores(q.to(torch.bfloat16), cb)
        want_v, want_i = torch.sort(scores, dim=1, descending=True, stable=True)
        got_i = torch.tensor([[art_row[a] for a in ans] for ans in got],
                             device=dev)
        got_v = torch.gather(scores, 1, got_i)
        err, mism = compare_ranked(got_v, got_i, want_v[:, :SERVE_K],
                                   want_i[:, :SERVE_K], scores)
        _, _, rounds = bt.exact_topk(q, emb_real, SERVE_K)
        row.update(rounds=rounds, query_blocks=-(-B // Q_BLOCK),
                   max_abs_err_vs_plain=err, id_mismatches=mism,
                   **serve_breakdown(svc, requests[B], repeats))
        emit({"serve": row})
    shared = {"ids": ids, "emb": emb, "requests": requests,
              "schema_dir": workdir / "schema", "model_dir": workdir / "model",
              "article_vocab": article_vocab, "art_row": art_row}
    return launches, shared


def serve_breakdown(svc, raw, repeats):
    """Medians over ``repeats`` calls that do what ``svc.retrieve(raw)``
    does, stage by stage: host encode (host clock); device, the query tower
    and the top-k (CUDA events from before the tower to after the top-k's
    last operation, host syncs inside it included); host decode (host clock
    from there: copy back, id -> string, per-row lists); and each call's
    total (host clock). Stages and totals come from the same calls."""
    stages = {"host_encode_ms": [], "device_ms": [], "host_decode_ms": [],
              "stages_total_ms": []}
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        batch = svc.encode_query(raw)
        t1 = time.perf_counter()
        start.record()
        _, ids = svc.index.topk_from_embeddings(svc.embed(batch))
        end.record()
        end.synchronize()
        t2 = time.perf_counter()
        svc.schema.candidate_id_feature.decode(ids.cpu().numpy()).tolist()
        t3 = time.perf_counter()
        for name, ms in zip(stages, ((t1 - t0) * 1e3, start.elapsed_time(end),
                                     (t3 - t2) * 1e3, (t3 - t0) * 1e3)):
            stages[name].append(ms)
    return {name: statistics.median(ts) for name, ts in stages.items()}


SINGLE_PASS_KERNELS = (
    "bin_max2_scaled_single_pass",
    "bin_max2_scaled_fold_pass",
    "bin_max2_raw_fold_pass",
)


def single_pass_bound_ms(B, n_rows, L, scaled, thresholds=False):
    """Least time of one int8 pass: the int8 codes (and, scaled, the fp32
    scales and bias; in a refinement round the two (B, L) thresholds), the
    bf16 query block and the four (B, L) outputs over HBM bandwidth, or the
    product's operations (bf16 tensor cores; the codes convert to bf16
    exactly) over the bf16 peak."""
    nbytes = n_rows * E + B * E * 2 + 4 * B * L * 4
    if scaled:
        nbytes += 2 * n_rows * 4
    if thresholds:
        nbytes += 2 * B * L * 4
    return roofline_ms(nbytes, 2 * B * n_rows * E)


def catalog_of(name):
    """The catalog kind of bin_max2.cu's template that a single pass
    instantiates (``bt.launch_info``'s ``catalog``)."""
    return "raw" if name == "bin_max2_raw_fold_pass" else "scaled"


def pass_args(name, args):
    """(L, F, scales, bias) of a single-pass wrapper's arguments after
    (q, codes)."""
    if name == "bin_max2_raw_fold_pass":
        return (*args, None, None)
    if name == "bin_max2_scaled_fold_pass":
        scales, bias, L, F = args
        return L, F, scales, bias
    scales, bias, L = args
    return L, 1, scales, bias


def plan_cases(codes, scales, bias, F, L):
    """{kernel name: (codes, wrapper arguments after (q, codes))} of the
    single passes at plan (F, L): the per-row pass (no fold at F = 1) over
    the whole padded catalog, the raw pass over its full chunks of real
    rows."""
    n_full = N_ARTICLES // (F * L) * (F * L)
    if F == 1:
        cases = {SINGLE_PASS_KERNELS[0]: (codes, (scales, bias, L))}
    else:
        cases = {SINGLE_PASS_KERNELS[1]: (codes, (scales, bias, L, F))}
    cases[SINGLE_PASS_KERNELS[2]] = (codes[:n_full], (L, F))
    return cases


def run_pass(name, q, codes, args, plain=False):
    """One single-pass kernel through its wrapper, or its plain version."""
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt

    if plain:
        return qt.single_pass_plain(q, codes, *pass_args(name, args))
    return getattr(qt, name)(q, codes, *args)


def pass_scores(q, codes, scales, bias):
    """(B, rows) fp32 scores a single pass ranks, for id comparisons."""
    from hm_retrieval_tpu_torch.ops import bin_topk as bt

    scores = bt.plain_scores(q, codes)
    return scores if scales is None else scores * scales + bias


def int8_catalog(gen, dev):
    """Random int8 codes of the H&M catalog padded with zero rows to
    N_PAD_Q, per-row scales (0 on pad rows) and a 0 / -inf bias."""
    codes = torch.zeros((N_PAD_Q, E), dtype=torch.int8, device=dev)
    codes[:N_ARTICLES] = torch.randint(-127, 128, (N_ARTICLES, E), generator=gen,
                                       device=dev, dtype=torch.int8)
    scales = torch.zeros(N_PAD_Q, device=dev)
    scales[:N_ARTICLES] = (
        torch.rand(N_ARTICLES, generator=gen, device=dev) * 0.05 + 1e-3
    )
    bias = torch.zeros(N_PAD_Q, device=dev)
    bias[N_ARTICLES:] = float("-inf")
    return codes, scales, bias


def phase_quantized_kernels(gen, dev):
    """Kernels 3-5 against their plain versions at every plan of
    QUANT_PLANS, timed there, and kernels 3-4 at other widths; then
    quantized_topk against a yardstick."""
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt

    codes, scales, bias = int8_catalog(gen, dev)
    stats = {n: {"max_abs_err": 0.0, "id_mismatches": 0, "shapes": []}
             for n in SINGLE_PASS_KERNELS}
    # the served (F, L, B) whose numbers head each kernel's entry
    headline = {
        "bin_max2_scaled_single_pass": (1, 2048, 1024),
        "bin_max2_scaled_fold_pass": (2, 2048, 128),
        "bin_max2_raw_fold_pass": (2, 2048, 128),
    }
    for F, L, B in QUANT_PLANS:
        cases = plan_cases(codes, scales, bias, F, L)
        check_clusters({name: bt.launch_info(B, E, L, threshold=False,
                                             catalog=catalog_of(name), fold=F,
                                             device=dev)
                        for name in cases}, L, B, F=F)
        for kind in ("integer", "normal"):
            if kind == "integer":
                q = torch.randint(-4, 5, (B, E), generator=gen, device=dev)
            else:
                q = torch.randn(B, E, generator=gen, device=dev)
            q = q.to(torch.bfloat16)
            for name, (c, args) in cases.items():
                got = run_pass(name, q, c, args)
                want = run_pass(name, q, c, args, plain=True)
                torch.cuda.synchronize()
                if kind == "integer":
                    for g, w in zip(got, want):
                        require(torch.equal(g, w), f"{name} F={F} L={L} B={B}: "
                                "integer inputs not bit-identical to the plain "
                                "version")
                    continue
                _, _, sc, bi = pass_args(name, args)
                scores = pass_scores(q, c, sc, bi)
                st = stats[name]
                for vi, ii in ((0, 1), (2, 3)):
                    err, mism = compare_ranked(
                        got[vi], got[ii], want[vi], want[ii], scores
                    )
                    st["max_abs_err"] = max(st["max_abs_err"], err)
                    st["id_mismatches"] += mism
                del scores
                bound, by = single_pass_bound_ms(B, c.shape[0], L, sc is not None)

                def launch():
                    return run_pass(name, q, c, args)

                row = {
                    "F": F, "L": L, "B": B, "rows": c.shape[0],
                    "ms": graph_ms(launch, 50),
                    "events_ms": cuda_ms(launch, 50),
                    "plain_ms": cuda_ms(lambda: run_pass(
                        name, q, c, args, plain=True), 3),
                    "bound_ms": bound, "bound_by": by,
                }
                st["shapes"].append(row)
                if headline[name] == (F, L, B):
                    st.update({k: row[k] for k in ("ms", "events_ms",
                                                   "plain_ms", "bound_ms",
                                                   "bound_by")})
            emit({"quantized_kernel_check": {"F": F, "L": L, "B": B,
                                             "inputs": kind, "ok": True}})

    # quantized_topk as a whole (pass + merge) against a yardstick the port
    # never calls: a bf16 product with the dequantized catalog + torch.topk
    deq = (codes[:N_ARTICLES].float() * scales[:N_ARTICLES, None]).to(
        torch.bfloat16)
    rows = []
    for B in (16, 128, 1024):
        q = torch.randn(B, E, generator=gen, device=dev)
        rows.append({
            "B": B, "k": SURVIVORS, "N": N_ARTICLES, "E": E,
            "plan": qt.single_pass_plan(B, E, SURVIVORS, N_PAD_Q),
            "ms": cuda_ms(lambda: qt.quantized_topk(
                q, codes, scales, SURVIVORS, n_valid=N_ARTICLES,
                max_rounds=1), 20),
            "yardstick_ms": cuda_ms(lambda: torch.topk(torch.matmul(
                q.to(torch.bfloat16), deq.T).float(), SURVIVORS), 20),
            "yardstick": "torch.matmul (bf16, dequantized catalog) + "
                         "torch.topk over (B, N)",
        })
    emit({"quantized_topk": rows})
    del codes, scales, bias, deq
    # the other instantiation (A fragments read from shared memory) of
    # kernels 3-5, at widths other than E = 128 up to the widest, on
    # integer inputs (with -inf bias rows for 3-4)
    for width in (64, 256, qt.INT8_KERNEL_MAX_E):
        L, n_rows, B = 1024, 16384, 37
        codes, scales, bias = scaled_catalog(gen, dev, n_rows, width, n_rows)
        q = torch.randint(-4, 5, (B, width), generator=gen,
                          device=dev).to(torch.bfloat16)
        for name, args in ((SINGLE_PASS_KERNELS[0], (scales, bias, L)),
                           (SINGLE_PASS_KERNELS[1], (scales, bias, L, 2)),
                           (SINGLE_PASS_KERNELS[2], (L, 1)),
                           (SINGLE_PASS_KERNELS[2], (L, 2))):
            got = run_pass(name, q, codes, args)
            want = run_pass(name, q, codes, args, plain=True)
            torch.cuda.synchronize()
            F = pass_args(name, args)[1]
            hold_cells(stats[name], f"{name} E={width} F={F}", "integer", got,
                       want, None)
        emit({"quantized_kernel_check": {"E": width, "L": L, "B": B,
                                         "inputs": "integer", "ok": True}})
    return stats


def plain_rounds():
    """Inside the block the int8 rounds driver runs the plain passes."""
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt

    return swapped(
        qt,
        bin_max2_scaled_first_round=lambda q, c, sc, bi, L, n: (
            qt.scaled_round_plain(q, c, sc, bi, L, n)),
        bin_max2_scaled_round=lambda q, c, sc, bi, ts, ti, L, n: (
            qt.scaled_round_plain(q, c, sc, bi, L, n, ts, ti)),
    )


def hold_cells(st, name, kind, got, want, scores_fn):
    """A pass's cells against its plain version's: bit-identical for
    integer inputs, else values within TOL and ids wherever the competing
    scores differ by more (``scores_fn()`` gives them)."""
    if kind == "integer":
        for g, w in zip(got, want):
            require(torch.equal(g, w), f"{name}: integer inputs not "
                    "bit-identical to the plain version")
        return
    scores = scores_fn()
    for vi in range(0, len(got), 2):
        err, mism = compare_ranked(got[vi], got[vi + 1], want[vi],
                                   want[vi + 1], scores)
        st["max_abs_err"] = max(st["max_abs_err"], err)
        st["id_mismatches"] += mism


def random_rows(gen, dev, kind, n):
    """(n, E) bf16 rows: integers in [-4, 4], or normal."""
    if kind == "integer":
        x = torch.randint(-4, 5, (n, E), generator=gen, device=dev)
    else:
        x = torch.randn(n, E, generator=gen, device=dev)
    return x.to(torch.bfloat16)


ROUNDS_KERNELS = ("bin_max2_scaled_first_round", "bin_max2_scaled_round")


def scaled_catalog(gen, dev, n_rows, width, n_valid):
    """Random int8 codes and per-row scales of ``n_rows`` rows, a -inf bias
    on 1% of the first ``n_valid`` and 0 past them: as quantized_topk pads
    what the rounds stream."""
    codes = torch.randint(-127, 128, (n_rows, width), generator=gen,
                          device=dev, dtype=torch.int8)
    scales = torch.rand(n_rows, generator=gen, device=dev) * 0.05 + 1e-3
    bias = torch.zeros(n_rows, device=dev)
    bias[:n_valid][torch.rand(n_valid, generator=gen, device=dev)
                   < 0.01] = float("-inf")
    return codes, scales, bias


def phase_rounds_kernels(gen, dev):
    """Kernels 6-8 against their plain versions at the served shapes:
    kernels 6-7 at every (B, L) of KERNEL_BATCHES x (2048, 1024), timed at
    TIMED_BATCHES, and at E = 64 and 256; kernel 8 at L = 2048 and 512."""
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt

    stats = {n: {"max_abs_err": 0.0, "id_mismatches": 0, "shapes": []}
             for n in ROUNDS_KERNELS + ("bin_max_round",)}
    # quantized_topk streams the chunks that hold a valid row: 106,496 of
    # the 131,072 rows at L = 2048 and at L = 1024 alike
    n_rows = -(-N_ARTICLES // 2048) * 2048
    n_valid = N_ARTICLES
    codes, scales, bias = scaled_catalog(gen, dev, n_rows, E, n_valid)
    for k, L in ((SERVE_K, 2048), (100, 1024)):
        require(bt.default_bins(k) == L and -(-n_valid // L) * L == n_rows,
                f"the rounds at k={k} do not stream {n_rows} rows at L={L}")
        for B in KERNEL_BATCHES:
            check_clusters({n: bt.launch_info(
                B, E, L, threshold=n == ROUNDS_KERNELS[1], catalog="scaled",
                device=dev) for n in ROUNDS_KERNELS}, L, B)
        for kind in ("integer", "normal"):
            q_all = random_rows(gen, dev, kind, Q_BLOCK)
            for B in KERNEL_BATCHES:
                q = q_all[:B]
                k6 = qt.bin_max2_scaled_first_round(q, codes, scales, bias, L,
                                                    n_valid)
                p6 = qt.scaled_round_plain(q, codes, scales, bias, L, n_valid)
                # each chain refines on the thresholds its own round 1
                # revealed
                k7 = qt.bin_max2_scaled_round(q, codes, scales, bias, k6[2],
                                              k6[3], L, n_valid)
                p7 = qt.scaled_round_plain(q, codes, scales, bias, L, n_valid,
                                           p6[2], p6[3])
                torch.cuda.synchronize()
                for name, got, want in ((ROUNDS_KERNELS[0], k6, p6),
                                        (ROUNDS_KERNELS[1], k7, p7)):
                    hold_cells(stats[name], f"{name} L={L} B={B}", kind, got,
                               want, lambda: pass_scores(q, codes, scales,
                                                         bias))
                emit({"rounds_kernel_check": {"kernels": "int8 rounds",
                                              "L": L, "B": B, "inputs": kind,
                                              "ok": True}})
                if kind != "normal" or L != 2048 or B not in TIMED_BATCHES:
                    continue
                for name, thr, plain in (
                    (ROUNDS_KERNELS[0], (), ()),
                    (ROUNDS_KERNELS[1], k6[2:], p6[2:]),
                ):
                    bound, by = single_pass_bound_ms(B, n_rows, L, True,
                                                     bool(thr))

                    def launch():
                        return getattr(qt, name)(q, codes, scales, bias,
                                                 *thr, L, n_valid)

                    row = {
                        "L": L, "B": B, "rows": n_rows,
                        "ms": graph_ms(launch, 50),
                        "events_ms": cuda_ms(launch, 50),
                        "plain_ms": cuda_ms(lambda: qt.scaled_round_plain(
                            q, codes, scales, bias, L, n_valid, *plain), 3),
                        "bound_ms": bound, "bound_by": by,
                    }
                    stats[name]["shapes"].append(row)
                    if B == Q_BLOCK:
                        stats[name].update({key: row[key] for key in (
                            "ms", "events_ms", "plain_ms", "bound_ms",
                            "bound_by")})
    del codes, scales, bias
    # the other instantiation (A fragments read from shared memory), at
    # widths other than E = 128, on integer inputs
    for width in (64, 256):
        L, B, n_valid = 1024, 37, 16000
        codes, scales, bias = scaled_catalog(gen, dev, 16384, width, n_valid)
        q = torch.randint(-4, 5, (B, width), generator=gen,
                          device=dev).to(torch.bfloat16)
        k6 = qt.bin_max2_scaled_first_round(q, codes, scales, bias, L,
                                            n_valid)
        p6 = qt.scaled_round_plain(q, codes, scales, bias, L, n_valid)
        checks = ((ROUNDS_KERNELS[0], k6, p6),
                  (ROUNDS_KERNELS[1],
                   qt.bin_max2_scaled_round(q, codes, scales, bias, k6[2],
                                            k6[3], L, n_valid),
                   qt.scaled_round_plain(q, codes, scales, bias, L, n_valid,
                                         p6[2], p6[3])))
        torch.cuda.synchronize()
        for name, got, want in checks:
            hold_cells(stats[name], f"{name} E={width}", "integer", got, want,
                       None)
        emit({"rounds_kernel_check": {"kernels": "int8 rounds", "E": width,
                                      "L": L, "B": B, "inputs": "integer",
                                      "ok": True}})

    st = stats["bin_max_round"]
    for L in (2048, 512):  # default_bins(k, 1) at k = 1000 and 100
        n_pad = -(-N_ARTICLES // L) * L
        inf_s = torch.full((Q_BLOCK, L), float("inf"), device=dev)
        inf_i = torch.full((Q_BLOCK, L), -1, dtype=torch.int32, device=dev)
        for kind in ("integer", "normal"):
            q = random_rows(gen, dev, kind, Q_BLOCK)
            c_pad = torch.zeros(n_pad, E, dtype=torch.bfloat16, device=dev)
            c_pad[:N_ARTICLES] = random_rows(gen, dev, kind, N_ARTICLES)
            k1 = bt.bin_max_round(q, c_pad, inf_s, inf_i, L, N_ARTICLES)
            p1 = bt.bin_max_plain(q, c_pad, inf_s, inf_i, L, N_ARTICLES)
            k2 = bt.bin_max_round(q, c_pad, *k1, L, N_ARTICLES)
            p2 = bt.bin_max_plain(q, c_pad, *p1, L, N_ARTICLES)
            torch.cuda.synchronize()
            for got, want in ((k1, p1), (k2, p2)):
                hold_cells(st, "bin_max_round", kind, got, want,
                           lambda: bt.plain_scores(q, c_pad))
            emit({"rounds_kernel_check": {"kernels": "single keep", "L": L,
                                          "B": Q_BLOCK, "inputs": kind,
                                          "ok": True}})
            if kind != "normal":
                continue
            bound, by = pass_bound_ms(Q_BLOCK, n_pad, L, True, outputs=2)
            def launch():
                return bt.bin_max_round(q, c_pad, *k1, L, N_ARTICLES)

            row = {
                "L": L, "B": Q_BLOCK, "rows": n_pad,
                "ms": graph_ms(launch, 50),
                "events_ms": cuda_ms(launch, 50),
                "plain_ms": cuda_ms(lambda: bt.bin_max_plain(
                    q, c_pad, *p1, L, N_ARTICLES), 3),
                "bound_ms": bound, "bound_by": by,
            }
            st["shapes"].append(row)
            if L == 2048:
                st.update({k: row[k] for k in ("ms", "events_ms", "plain_ms",
                                               "bound_ms", "bound_by")})
    return stats


def phase_rounds_drivers(gen, dev):
    """The drivers of kernels 6-8 and the lockstep driver. Returns the
    launches of the single-keep path (exact_topk(keep_per_bin=1))."""
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt

    codes, scales, _ = int8_catalog(gen, dev)
    deq = (codes[:N_ARTICLES].float() * scales[:N_ARTICLES, None]).to(
        torch.bfloat16)
    rows = []
    for B in (128, 1024):
        q = torch.randn(B, E, generator=gen, device=dev)
        v, i, rounds = qt.quantized_topk(q, codes, scales, SURVIVORS,
                                         n_valid=N_ARTICLES)
        blocks = [qt.quantized_topk(q[s:s + Q_BLOCK], codes, scales, SURVIVORS,
                                    n_valid=N_ARTICLES)
                  for s in range(0, B, Q_BLOCK)]
        require(torch.equal(v, torch.cat([b[0] for b in blocks]))
                and torch.equal(i, torch.cat([b[1] for b in blocks]))
                and rounds == max(b[2] for b in blocks),
                f"B={B}: the rounds do not answer as their blocks alone")
        per_block = [b[2] for b in blocks]
        done = torch.tensor([r < MAX_ROUNDS for r in per_block],
                            device=dev).repeat_interleave(Q_BLOCK)
        err, mism = 0.0, 0
        if bool(done.any()):  # the dequantized scores of the bf16 queries
            scores = (bt.plain_scores(q[done].to(torch.bfloat16),
                                      codes[:N_ARTICLES]) * scales[:N_ARTICLES])
            sv, si = torch.sort(scores, dim=1, descending=True, stable=True)
            err, mism = compare_ranked(v[done], i[done], sv[:, :SURVIVORS],
                                       si[:, :SURVIVORS], scores)
            del scores, sv, si
        rows.append({
            "driver": "quantized_topk", "B": B, "k": SURVIVORS, "L": 2048,
            "rounds_per_block": per_block, "exact_rows": int(done.sum()),
            "max_abs_err_vs_exact": err, "id_mismatches": mism,
            "ms": cuda_ms(lambda: qt.quantized_topk(
                q, codes, scales, SURVIVORS, n_valid=N_ARTICLES), 10),
            "yardstick_ms": cuda_ms(lambda: torch.topk(torch.matmul(
                q.to(torch.bfloat16), deq.T).float(), SURVIVORS), 10),
            "yardstick": "torch.matmul (bf16, dequantized catalog) + "
                         "torch.topk over (B, N)",
        })
    del codes, scales, deq

    c = torch.randn(N_ARTICLES, E, generator=gen, device=dev)
    cb = c.to(torch.bfloat16)
    q = torch.randn(Q_BLOCK, E, generator=gen, device=dev)
    # --- the single-keep path: counts from 0 -----------------------------
    bt.reset_launches()
    keep1 = {k: bt.exact_topk(q, c, k, keep_per_bin=1) for k in (100, 1000)}
    launches = dict(bt.LAUNCHES)
    # ---------------------------------------------------------------------
    require(launches["bin_max_round"] > 0 and launches["bin_max2_round"] == 0
            and launches["bin_max2_first_round"] == 0,
            f"exact_topk(keep_per_bin=1) launched {launches}")
    scores = bt.plain_scores(q.to(torch.bfloat16), cb)
    sv, si = torch.sort(scores, dim=1, descending=True, stable=True)
    for k, (v, i, rounds) in keep1.items():
        with swapped(bt, bin_max_round=bt.bin_max_plain):
            pv, pi, prounds = bt.exact_topk(q, c, k, keep_per_bin=1)
        require(rounds == prounds, f"keep 1, k={k}: {rounds} rounds, the "
                f"plain pass {prounds}")
        err, mism = compare_ranked(v, i, pv, pi, scores)
        row = {"driver": "exact_topk(keep_per_bin=1)", "B": Q_BLOCK, "k": k,
               "L": bt.default_bins(k, 1), "rounds": rounds,
               "max_abs_err_vs_plain_driver": err,
               "id_mismatches_vs_plain_driver": mism}
        if rounds < MAX_ROUNDS:
            row["max_abs_err_vs_exact"], row["id_mismatches_vs_exact"] = (
                compare_ranked(v, i, sv[:, :k], si[:, :k], scores))
        row.update(
            ms=cuda_ms(lambda: bt.exact_topk(q, c, k, keep_per_bin=1), 10),
            keep2_ms=cuda_ms(lambda: bt.exact_topk(q, c, k), 10),
            keep2_rounds=bt.exact_topk(q, c, k)[2],
            yardstick_ms=cuda_ms(lambda: torch.topk(torch.matmul(
                q.to(torch.bfloat16), cb.T).float(), k), 10),
        )
        rows.append(row)
    del scores, sv, si

    q = torch.randn(1024, E, generator=gen, device=dev)
    bt.reset_launches()
    v1, i1, r1 = bt.exact_topk(q, c, SERVE_K, lockstep=True)
    lock_launches = dict(bt.LAUNCHES)
    v0, i0, r0 = bt.exact_topk(q, c, SERVE_K)
    require(torch.equal(i1, i0) and torch.equal(v1, v0),
            "lockstep ids differ from the per-block driver's")
    require(lock_launches["bin_max2_first_round"] == 1
            and lock_launches["bin_max2_round"] == r1 - 1,
            f"lockstep did not launch once per round: {lock_launches}")
    rows.append({
        "driver": "exact_topk(lockstep=True)", "B": 1024, "k": SERVE_K,
        "L": 2048, "rounds": r1, "per_block_rounds": r0,
        "launches": lock_launches,
        "ms": cuda_ms(lambda: bt.exact_topk(q, c, SERVE_K, lockstep=True), 5),
        "per_block_ms": cuda_ms(lambda: bt.exact_topk(q, c, SERVE_K), 5),
    })
    for row in rows:
        emit({"rounds_driver": row})
    return launches


def phase_rounds_serving(shared, single_pass_recall, repeats, dev, workdir):
    """Quantized serving with the int8 rounds (pallas_rounds = 8)."""
    from hm_retrieval_tpu_torch.indices import quantized as pq
    from hm_retrieval_tpu_torch.indices.quantized import QuantizedIndex
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt
    from hm_retrieval_tpu_torch.serving import RetrievalService

    requests = shared["requests"]
    services = {}
    for mode in ("per_row", "global"):
        t0 = time.perf_counter()
        index = QuantizedIndex(SERVE_K, shared["ids"], shared["emb"],
                               method="auto", scale_mode=mode,
                               pallas_rounds=MAX_ROUNDS, device=dev)
        require(index.method == "pallas" and index.k_over == SURVIVORS,
                f"rounds {mode}: auto resolved to {index.method!r} with "
                f"{index.k_over} survivors")
        path = workdir / f"rounds_{mode}"
        index.save(str(path))
        svc = RetrievalService.load(str(shared["schema_dir"]),
                                    str(shared["model_dir"]), str(path),
                                    device=dev)
        loaded = svc.index
        require(isinstance(loaded, QuantizedIndex) and loaded.method == "pallas"
                and loaded.pallas_rounds == MAX_ROUNDS
                and loaded.k_over == SURVIVORS and loaded.scale_mode == mode
                and loaded.codes.shape[0] == N_PAD_Q,
                f"rounds {mode}: the loaded index does not run the rounds")
        services[mode] = svc
        emit({"rounds_setup": {"scale_mode": mode,
                               "seconds": time.perf_counter() - t0,
                               "pallas_rounds": loaded.pallas_rounds,
                               "k_over": loaded.k_over}})

    # --- the main path: counts from 0, served requests only -------------
    bt.reset_launches()
    qt.reset_launches()
    rows, answers = [], {}
    for mode, svc in services.items():
        for B in SERVE_BATCHES:
            before = dict(qt.LAUNCHES)
            svc.retrieve(requests[B])  # warm-up
            times = []
            for _ in range(repeats):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                answers[mode, B] = svc.retrieve(requests[B])
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            per_batch = {n: (qt.LAUNCHES[n] - before[n]) / (repeats + 1)
                         for n in qt.LAUNCHES}
            rows.append({"scale_mode": mode, "B": B,
                         "median_ms": statistics.median(times),
                         "min_ms": min(times), "max_ms": max(times),
                         "launches_per_batch": per_batch})
    launches = dict(qt.LAUNCHES)
    exact_launches = dict(bt.LAUNCHES)
    # ---------------------------------------------------------------------
    require(all(launches[n] > 0 for n in ROUNDS_KERNELS)
            and not any(launches[n] for n in SINGLE_PASS_KERNELS)
            and not any(exact_launches.values()),
            f"the rounds path launched {launches}, {exact_launches}")

    emb_real = shared["emb"]
    for row in rows:
        mode, B = row["scale_mode"], row["B"]
        svc = services[mode]
        index = svc.index
        got = answers[mode, B]
        require(len(got) == B, f"rounds {mode} B={B}: {len(got)} answers")
        for ans in got:
            require(len(ans) == SERVE_K and len(set(ans)) == SERVE_K,
                    f"rounds {mode} B={B}: an answer is not {SERVE_K} "
                    "distinct articles")
            require(set(ans) <= shared["article_vocab"],
                    f"rounds {mode} B={B}: unknown article")
        with torch.no_grad():
            q = svc.embed(svc.encode_query(requests[B]))
        survivors = []

        def recording(queries, codes, scales, *args, **kwargs):
            out = qt.quantized_topk(queries, codes, scales, *args, **kwargs)
            survivors.append((queries, codes, scales, out))
            return out

        with swapped(pq, quantized_topk=recording):
            kv, kid = index.topk_from_embeddings(q)
            with plain_rounds():
                pv, pid = index.topk_from_embeddings(q)
        decoded = svc.schema.candidate_id_feature.decode(kid.cpu().numpy())
        require(decoded.tolist() == got,
                f"rounds {mode} B={B}: served answers differ from a rerun")
        (qs, codes, scales, (ksv, ks, k_rounds)), (_, _, _, (psv, ps, p_rounds)) = (
            survivors)
        # every row's survivors against the plain passes', over the
        # dequantized scores (bf16 queries, fp32 sums, * scale)
        n = index.num_candidates
        deq = bt.plain_scores(qs.to(torch.bfloat16), codes[:n]) * scales[:n]
        surv_err, surv_mism = compare_ranked(ksv, ks, psv, ps, deq)
        diff = ks != ps
        swapped_at = diff.nonzero()  # (row, rank) of each swapped survivor
        swap_gap = (deq[swapped_at[:, 0], ks[diff].long()]
                    - deq[swapped_at[:, 0], ps[diff].long()]).abs()
        del deq
        survivors_differ = diff.any(1)
        answers_differ = ((kid != pid) | (kv != pv)).any(1)
        require(not bool((answers_differ & ~survivors_differ).any()),
                f"rounds {mode} B={B}: answers differ from the plain "
                "composition where the survivors agree")
        exact = bt.plain_scores(q, emb_real)
        top = torch.sort(exact, dim=1, descending=True, stable=True)[1][:, :SERVE_K]
        del exact
        hit = torch.zeros((B, N_ARTICLES), dtype=torch.bool, device=dev)
        hit.scatter_(1, top, True)
        recall = float(torch.gather(hit, 1, kid.long() - 1).float().mean())
        row.update(rounds=k_rounds, plain_rounds=p_rounds,
                   survivors_max_abs_err_vs_plain=surv_err,
                   survivor_id_mismatches=surv_mism,
                   survivor_swap_max_score_gap=(
                       float(swap_gap.max()) if surv_mism else 0.0),
                   survivor_first_swapped_rank=(
                       int(swapped_at[:, 1].min()) if surv_mism else None),
                   rows_with_other_survivors=int(survivors_differ.sum()),
                   rows_answered_otherwise=int(answers_differ.sum()),
                   recall_vs_exact=recall,
                   single_pass_recall_vs_exact=single_pass_recall[mode, B],
                   **serve_breakdown(svc, requests[B], repeats))
        emit({"rounds_serve": row})
    return launches


@contextlib.contextmanager
def swapped(module, **fns):
    """Inside the block, ``module.<name>`` is ``fns[name]``."""
    saved = {name: getattr(module, name) for name in fns}
    for name, fn in fns.items():
        setattr(module, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


@contextlib.contextmanager
def recorded_passes(plain):
    """Inside the block the single-pass drivers reach the kernel wrappers
    (or, with ``plain``, the plain versions) through recording stand-ins.
    Yields the list of (q, codes, scales, bias, outputs) of each pass."""
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt

    record = []

    def stand_in(name):
        wrapper = getattr(qt, name)

        def run(q, codes, *args):
            L, F, sc, bi = pass_args(name, args)
            out = (qt.single_pass_plain(q, codes, L, F, sc, bi) if plain
                   else wrapper(q, codes, *args))
            record.append((q, codes, sc, bi, out))
            return out
        return run

    with swapped(qt, **{n: stand_in(n) for n in SINGLE_PASS_KERNELS}):
        yield record


def check_device_build(index, emb_host, mode):
    """The index quantized on the card must equal the host quantization of
    the same catalog bit for bit: codes, scales (one global scale, or one
    per row), zero codes and scales on pad rows, bias 0 / -inf."""
    from hm_retrieval_tpu_torch.indices.quantized import (
        quantize_rows, quantize_rows_global,
    )

    n = N_ARTICLES
    if mode == "global":
        codes, g = quantize_rows_global(emb_host)
        scales = np.full(n, g, np.float32)
        require(index.global_scale == float(g),
                f"global: device scale {index.global_scale} != host {float(g)}")
    else:
        codes, scales = quantize_rows(emb_host)
    require(np.array_equal(index.codes[:n].cpu().numpy(), codes)
            and np.array_equal(index.scales[:n].cpu().numpy(), scales),
            f"{mode}: the device build's codes or scales differ from the "
            "host build's")
    bias = index._score_bias
    require(not bool(index.codes[n:].any()) and not bool(index.scales[n:].any())
            and not bool(bias[:n].any()) and bool(torch.isneginf(bias[n:]).all()),
            f"{mode}: the device build's padding is wrong")


def phase_quantized_serving(shared, repeats, dev, workdir):
    from hm_retrieval_tpu_torch.indices.quantized import QuantizedIndex
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt
    from hm_retrieval_tpu_torch.serving import RetrievalService

    requests = shared["requests"]
    emb_host = shared["emb"].cpu().numpy()
    services = {}
    for mode in ("per_row", "global"):
        t0 = time.perf_counter()
        index = QuantizedIndex(SERVE_K, shared["ids"], shared["emb"],
                               method="auto", scale_mode=mode, device=dev)
        require(index.method == "pallas" and index.k_over == SURVIVORS,
                f"{mode}: auto resolved to {index.method!r} with "
                f"{index.k_over} survivors")
        check_device_build(index, emb_host, mode)
        path = workdir / f"quantized_{mode}"
        index.save(str(path))
        svc = RetrievalService.load(str(shared["schema_dir"]),
                                    str(shared["model_dir"]), str(path),
                                    device=dev)
        loaded = svc.index
        require(isinstance(loaded, QuantizedIndex) and loaded.method == "pallas"
                and loaded.k_over == SURVIVORS and loaded.scale_mode == mode,
                f"{mode}: the loaded index does not run the kernels")
        require(loaded.codes.shape[0] == N_PAD_Q, "codes are not padded to "
                f"{N_PAD_Q} rows")
        require(torch.equal(loaded.codes, index.codes)
                and torch.equal(loaded.scales, index.scales)
                and loaded.global_scale == index.global_scale,
                f"{mode}: the loaded index's codes or scales differ from the "
                "device build's")
        services[mode] = svc
        emit({"quantized_setup": {"scale_mode": mode,
                                  "seconds": time.perf_counter() - t0,
                                  "k_over": loaded.k_over,
                                  "codes": list(loaded.codes.shape)}})

    # --- the main path: counts from 0, served requests only -------------
    bt.reset_launches()
    qt.reset_launches()
    rows, answers = [], {}
    for mode, svc in services.items():
        for B in SERVE_BATCHES:
            before = dict(qt.LAUNCHES)
            svc.retrieve(requests[B])  # warm-up
            times = []
            for _ in range(repeats):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                answers[mode, B] = svc.retrieve(requests[B])
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            per_batch = {n: (qt.LAUNCHES[n] - before[n]) / (repeats + 1)
                         for n in qt.LAUNCHES}
            rows.append({"scale_mode": mode, "B": B,
                         "median_ms": statistics.median(times),
                         "min_ms": min(times), "max_ms": max(times),
                         "launches_per_batch": per_batch})
    launches = dict(qt.LAUNCHES)
    exact_launches = dict(bt.LAUNCHES)
    # ---------------------------------------------------------------------
    require(all(launches[n] > 0 for n in SINGLE_PASS_KERNELS)
            and not any(launches[n] for n in launches
                        if n not in SINGLE_PASS_KERNELS),
            f"the single-pass path launched {launches}")
    require(not any(exact_launches.values()),
            f"the quantized path launched the exact kernels: {exact_launches}")

    emb_real = shared["emb"]
    for row in rows:
        mode, B = row["scale_mode"], row["B"]
        svc = services[mode]
        index = svc.index
        if mode == "global":
            expected = "bin_max2_raw_fold_pass"
            plan = qt.single_pass_plan(B, E, SURVIVORS, N_ARTICLES)
        else:
            expected = SINGLE_PASS_KERNELS[1 if B <= 128 else 0]
            plan = qt.single_pass_plan(B, E, SURVIVORS, N_PAD_Q)
        require(row["launches_per_batch"][expected] == 1,
                f"{mode} B={B}: {expected} did not run once per batch: "
                f"{row['launches_per_batch']}")
        got = answers[mode, B]
        require(len(got) == B, f"{mode} B={B}: {len(got)} answers")
        for ans in got:
            require(len(ans) == SERVE_K and len(set(ans)) == SERVE_K,
                    f"{mode} B={B}: an answer is not {SERVE_K} distinct "
                    "articles")
            require(set(ans) <= shared["article_vocab"],
                    f"{mode} B={B}: unknown article")
        with torch.no_grad():
            q = svc.embed(svc.encode_query(requests[B]))
        with recorded_passes(plain=False) as rec_k:
            kv, kid = index.topk_from_embeddings(q)
        with recorded_passes(plain=True) as rec_p:
            pv, pid = index.topk_from_embeddings(q)
        decoded = svc.schema.candidate_id_feature.decode(kid.cpu().numpy())
        require(decoded.tolist() == got,
                f"{mode} B={B}: served answers differ from a rerun")
        # the pass against its plain version on the served queries
        qp, c, sc, bi, kout = rec_k[0]
        pout = rec_p[0][4]
        scores = pass_scores(qp, c, sc, bi)
        err, mism = 0.0, 0
        for vi, ii in ((0, 1), (2, 3)):
            e, m = compare_ranked(kout[vi], kout[ii], pout[vi], pout[ii],
                                  scores)
            err, mism = max(err, e), mism + m
        del scores
        # where both passes keep the same survivors, the answers are equal
        survivors_differ = ((kout[1] != pout[1]) | (kout[3] != pout[3])).any(1)
        answers_differ = ((kid != pid) | (kv != pv)).any(1)
        require(not bool((answers_differ & ~survivors_differ).any()),
                f"{mode} B={B}: answers differ from the plain composition "
                "where the survivors agree")
        # recall against the exact fp32 top-1000 (a reading, not a gate)
        exact = bt.plain_scores(q, emb_real)
        top = torch.sort(exact, dim=1, descending=True, stable=True)[1][:, :SERVE_K]
        del exact
        hit = torch.zeros((B, N_ARTICLES), dtype=torch.bool, device=dev)
        hit.scatter_(1, top, True)
        recall = float(torch.gather(hit, 1, kid.long() - 1).float().mean())
        row.update(plan=plan, pass_max_abs_err_vs_plain=err,
                   pass_id_mismatches=mism,
                   rows_with_other_survivors=int(survivors_differ.sum()),
                   rows_answered_otherwise=int(answers_differ.sum()),
                   recall_vs_exact=recall,
                   **serve_breakdown(svc, requests[B], repeats))
        emit({"quantized_serve": row})
    recalls = {(row["scale_mode"], row["B"]): row["recall_vs_exact"]
               for row in rows}
    return launches, recalls


WIDTH_ROWS = 20_000  # over 16,384: BruteForceIndex("auto") takes the kernels
WIDTH_K = 100  # the quantized indices' k (400 survivors)


class Records(logging.Handler):
    """Collects the port's log records."""

    def __init__(self, level=logging.WARNING):
        super().__init__(level)
        self.records = []

    def emit(self, record):
        self.records.append(record.getMessage())


def phase_widths(seed, dev):
    """Widths the kernels do not take as they are, on the card against the
    same indices on the CPU, over WIDTH_ROWS rows of integer-valued
    embeddings (exact in bf16 and in fp32 sums, so the answers must be
    bit-identical): BruteForceIndex("auto") and QuantizedIndex one pass and
    with 8 rounds at E = 8 and 100 run the kernels on E padded to a
    multiple of 16; at E = 520 BruteForceIndex runs "full" and the rounds
    "scan" (past KERNEL_MAX_E = 512), the one pass the kernels (528 <=
    INT8_KERNEL_MAX_E = 576), and at E = 600 the one pass runs "scan", each
    route with a log line."""
    from hm_retrieval_tpu_torch.indices.brute_force import BruteForceIndex
    from hm_retrieval_tpu_torch.indices.quantized import QuantizedIndex
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt

    rng = np.random.default_rng(seed)
    indices = {
        "exact": lambda i, x, d: BruteForceIndex(SERVE_K, i, x, device=d),
        "quantized_one_pass": lambda i, x, d: QuantizedIndex(
            WIDTH_K, i, x, device=d),
        "quantized_rounds": lambda i, x, d: QuantizedIndex(
            WIDTH_K, i, x, pallas_rounds=MAX_ROUNDS, device=d),
    }
    cases = [(w, name, "pallas") for w in (8, 100) for name in indices]
    cases += [(520, "exact", "full"), (520, "quantized_rounds", "scan"),
              (520, "quantized_one_pass", "pallas"),
              (600, "quantized_one_pass", "scan")]
    log = Records()
    logging.getLogger("hm_retrieval_tpu_torch").addHandler(log)
    rows = []
    try:
        for width, name, engine in cases:
            ids = np.arange(1, WIDTH_ROWS + 1, dtype=np.int32)
            emb = rng.integers(-4, 5, (WIDTH_ROWS, width)).astype(np.float32)
            q = rng.integers(-4, 5, (16, width)).astype(np.float32)
            del log.records[:]
            card = indices[name](ids, emb, dev)
            host = indices[name](ids, emb, "cpu")
            routed = [m for m in log.records if "widest" in m]
            require(card._engine == host._engine == engine
                    and len(routed) == 2 * (engine != "pallas"),
                    f"{name} E={width}: engine {card._engine!r}, expected "
                    f"{engine!r}; log {log.records}")
            # --- this path: counts from 0 ---------------------------------
            bt.reset_launches()
            qt.reset_launches()
            got = card.topk_from_embeddings(torch.tensor(q, device=dev))
            torch.cuda.synchronize()
            launches = {n: c for n, c in {**bt.LAUNCHES, **qt.LAUNCHES}.items()
                        if c}
            # -----------------------------------------------------------------
            require(bool(launches) == (engine == "pallas"),
                    f"{name} E={width}: launched {launches}")
            want = host.topk_from_embeddings(torch.tensor(q))
            require(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
                    f"{name} E={width}: the card's answers differ from the "
                    "CPU's")
            rows.append({"E": width, "index": name, "engine": engine,
                         "launches": launches, "log": routed[:1],
                         "identical_to_cpu": True})
    finally:
        logging.getLogger("hm_retrieval_tpu_torch").removeHandler(log)
    for row in rows:
        emit({"width": row})
    # the one pass's kernels at the widest padded widths they serve
    for width in (528, qt.INT8_KERNEL_MAX_E):
        for B in (16, Q_BLOCK):
            emit({"width_launch": {"E": width, "B": B, **{
                name: bt.launch_info(B, width, 2048, threshold=False,
                                     catalog=catalog_of(name), fold=F,
                                     device=dev)
                for name, F in (("bin_max2_scaled_single_pass", 1),
                                ("bin_max2_scaled_fold_pass", 2),
                                ("bin_max2_raw_fold_pass", 2))}}})


# --- phase 9: training ------------------------------------------------------
TRAIN_B = 512  # TrainingConfig's train_batch_size
TRAIN_WARMUP, TRAIN_STEPS = 8, 48  # untimed, then timed steps a path
TRAIN_ROWS = 64 * TRAIN_B  # rows of the synthetic shards
SHARD_ROWS = 8192
ACTIVE_CUSTOMERS = 4096  # customers that buy, spread over the full table
HISTORY_LEN = 16  # BASELINE config[3]'s purchase history
NUM_NEGATIVES = 512  # uniform negatives of the mixed path
CHUNK_K = 8  # steps a chunk on the chunked path
SMALL_CUSTOMERS, SMALL_ARTICLES = 5000, 2000  # the card-against-CPU check
ADAM_LR = 1e-3  # the reference's Keras Adam default
# Adam's eps in the card-against-CPU check only: at 1e-8 Adam divides
# rounding noise by eps where a gradient is zero in exact arithmetic (the
# candidate tower's last bias, which the in-batch softmax cannot see), so two
# summation orders differ there by up to lr
CHECK_ADAM_EPS = 1e-3
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-5  # card vs CPU, fp32, 3 steps
FP32_FLOPS = 67e12  # H100 SXM fp32 peak outside the tensor cores, published
# (name, TrainingConfig fields, purchase history?)
TRAIN_PATHS = (
    ("sparse_adagrad", {}, False),
    ("sparse_adagrad_history", {}, True),
    ("dense_adagrad", {"use_sparse_embedding_optimizer": False}, False),
    ("dense_adam", {"optimizer_name": "adam",
                    "optimizer_kwargs": {"learning_rate": ADAM_LR}}, False),
    ("mixed_negatives", {"num_uniform_negatives": NUM_NEGATIVES}, False),
    ("chunked_k8", {"steps_per_dispatch": CHUNK_K}, False),
)


def sized_feature(name, kind, family, width, rows, **kw):
    """A feature whose table holds ``rows`` ids past OOV, without building a
    vocab of ``rows`` strings (as bench.py's H&M-scale model does)."""
    from hm_retrieval_tpu_torch.schema import Feature

    class Sized(Feature):
        @property
        def num_embeddings(self):
            return rows + 1

    return Sized(name, kind, family, embedding_size=width,
                 vocab=np.array(["x"]), **kw)


def article_popularity(n_articles):
    """bench.py's logQ: Dirichlet(0.5) popularity from seed 0; logq[0] = 0."""
    probs = np.random.default_rng(0).dirichlet(np.full(n_articles, 0.5))
    logq = np.zeros(n_articles + 1, np.float32)
    logq[1:] = np.log(probs + 1e-12).astype(np.float32)
    return probs, logq


def train_model(n_customers, n_articles, logq, history, dev):
    """bench.py's H&M model (``hm_scale_model``) from the port's classes."""
    from hm_retrieval_tpu_torch.models import TwoTowerModel

    query = [sized_feature("customer_id", "categorical", "query", E,
                           n_customers)]
    if history:
        query.append(sized_feature(
            "purchase_history", "sequence", "query", E, n_articles,
            max_len=HISTORY_LEN, pooling="mean"))
    candidate = [
        sized_feature("article_id", "categorical", "candidate", E, n_articles),
        sized_feature("product_type_name", "categorical", "candidate", 16,
                      N_PRODUCT_TYPES),
        sized_feature("colour_group_name", "categorical", "candidate", 8,
                      N_COLOURS),
    ]
    return TwoTowerModel(query, candidate, "article_id", E, [256], [256],
                         logq=logq, device=dev)


def train_columns(rng, n_rows, n_customers, n_articles, probs):
    """A learnable stream: each of ACTIVE_CUSTOMERS customers (spread over
    the whole table) buys its favourite article 80% of the time and a
    popular one otherwise; the history mixes the favourite with popular
    articles, padded at random lengths. Product type and colour are
    attributes of the article. Returns the rows and the catalog columns."""
    n_active = min(ACTIVE_CUSTOMERS, n_customers)
    active = rng.choice(n_customers, n_active, replace=False) + 1
    favourite = rng.choice(n_articles, n_active, p=probs) + 1
    product_type = rng.integers(1, N_PRODUCT_TYPES + 1, n_articles + 1)
    colour = rng.integers(1, N_COLOURS + 1, n_articles + 1)
    who = rng.integers(0, n_active, n_rows)
    article = np.where(rng.random(n_rows) < 0.8, favourite[who],
                       rng.choice(n_articles, n_rows, p=probs) + 1)
    hist = np.where(rng.random((n_rows, HISTORY_LEN)) < 0.5,
                    favourite[who][:, None],
                    rng.choice(n_articles, (n_rows, HISTORY_LEN), p=probs) + 1)
    hist[np.arange(HISTORY_LEN) >= rng.integers(0, HISTORY_LEN + 1,
                                                n_rows)[:, None]] = 0
    rows = {
        "customer_id": active[who].astype(np.int32),
        "purchase_history": hist.astype(np.int32),
        "article_id": article.astype(np.int32),
        "product_type_name": product_type[article].astype(np.int32),
        "colour_group_name": colour[article].astype(np.int32),
    }
    ids = np.arange(1, n_articles + 1)
    catalog = {"article_id": ids.astype(np.int32),
               "product_type_name": product_type[ids].astype(np.int32),
               "colour_group_name": colour[ids].astype(np.int32)}
    return rows, catalog


def write_shards(dirpath, rows, shard_rows=SHARD_ROWS):
    """``shard_*.npz`` of ``shard_rows`` rows plus the manifest
    ``ShardDataset`` reads."""
    from hm_retrieval_tpu_torch.data import MANIFEST_NAME

    dirpath.mkdir(parents=True)
    n = len(next(iter(rows.values())))
    for s, lo in enumerate(range(0, n, shard_rows)):
        np.savez(dirpath / f"shard_{s:05d}.npz",
                 **{k: v[lo:lo + shard_rows] for k, v in rows.items()})
    (dirpath / MANIFEST_NAME).write_text(json.dumps({
        "num_rows": n, "num_shards": -(-n // shard_rows),
        "max_rows": shard_rows,
        "features": {k: str(v.dtype) for k, v in rows.items()}}))


def training_config(fields, check=False):
    from hm_retrieval_tpu_torch.schema import TrainingConfig

    fields = dict(fields)
    if check and fields.get("optimizer_name") == "adam":
        fields["optimizer_kwargs"] = {**fields["optimizer_kwargs"],
                                      "eps": CHECK_ADAM_EPS}
    return TrainingConfig(**fields)


def to_device(batch, dev):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


def phase_training_vs_cpu(dev):
    """Each path's card step against the port's own CPU step at a reduced
    vocabulary and the full widths: 3 steps (one chunk of 3 on the chunked
    path) from one state, the loss and every tensor of the state within
    TRAIN_RTOL / TRAIN_ATOL."""
    from hm_retrieval_tpu_torch.data import make_chunked_train_step
    from hm_retrieval_tpu_torch.models import (
        make_single_device_trainer, train_state_from_numpy,
        train_state_to_numpy,
    )
    from hm_retrieval_tpu_torch.models.mixed_negatives import (
        CandidateCatalog, step_seed,
    )

    rng = np.random.default_rng(1)
    probs, logq = article_popularity(SMALL_ARTICLES)
    rows, catalog_cols = train_columns(rng, 3 * TRAIN_B, SMALL_CUSTOMERS,
                                       SMALL_ARTICLES, probs)
    batches = [{k: v[i * TRAIN_B:(i + 1) * TRAIN_B] for k, v in rows.items()}
               for i in range(3)]
    out = {}
    for name, fields, history in TRAIN_PATHS:
        tc = training_config(fields, check=True)
        side = []  # (catalog, state, step) on the card, then on the CPU
        for d in (dev, torch.device("cpu")):
            model = train_model(SMALL_CUSTOMERS, SMALL_ARTICLES, logq, history,
                                d)
            catalog = (CandidateCatalog(catalog_cols, device=d)
                       if tc.num_uniform_negatives else None)
            side.append((catalog,
                         *make_single_device_trainer(model, tc, catalog)))
        (card_cat, card_state, card_step), (_, cpu_state, cpu_step) = side
        # one seed gives the card the CPU's initial weights, bit for bit
        require(all(torch.equal(t.cpu(), cpu_state.params[key])
                    for key, t in card_state.params.items()),
                f"{name}: one seed drew other initial weights on the card")
        cpu_state = train_state_from_numpy(cpu_state,
                                           train_state_to_numpy(card_state))
        losses = {"cuda": [], "cpu": []}
        if name.startswith("chunked"):
            stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
            card_state, m = make_chunked_train_step(card_step)(
                card_state, to_device(stacked, dev))
            losses["cuda"] = m["losses"].tolist()
            for b in batches:
                cpu_state, m = cpu_step(cpu_state, to_device(b, "cpu"))
                losses["cpu"].append(float(m["loss"]))
        else:
            gen = torch.Generator(device=dev)
            for b in batches:
                kw = [{}, {}]
                if card_cat is not None:  # the same rows on both sides
                    gen.manual_seed(step_seed(tc.seed, card_state.step))
                    neg = card_cat.sample(gen, tc.num_uniform_negatives)
                    kw = [{"negatives": neg},
                          {"negatives": {k: v.cpu() for k, v in neg.items()}}]
                card_state, m = card_step(card_state, to_device(b, dev), **kw[0])
                losses["cuda"].append(float(m["loss"]))
                cpu_state, m = cpu_step(cpu_state, to_device(b, "cpu"), **kw[1])
                losses["cpu"].append(float(m["loss"]))
        got = {k: t.cpu() for k, t in state_tensors(card_state).items()}
        want = state_tensors(cpu_state)
        require(set(got) == set(want), f"{name}: state layouts differ")
        worst, worst_name = 0.0, None
        for key, w in want.items():
            g = got[key]
            if not w.is_floating_point():
                require(torch.equal(g, w), f"{name}: {key} differs")
                continue
            err = (g - w).abs()
            require(bool((err <= TRAIN_ATOL + TRAIN_RTOL * w.abs()).all()),
                    f"{name}: {key} outside tolerance, max err "
                    f"{float(err.max())}")
            if float(err.max()) > worst:
                worst, worst_name = float(err.max()), key
        lc, lh = np.array(losses["cuda"]), np.array(losses["cpu"])
        require(np.all(np.abs(lc - lh) <= TRAIN_ATOL + TRAIN_RTOL * np.abs(lh)),
                f"{name}: losses {lc} on the card, {lh} on the CPU")
        require(card_state.step == cpu_state.step == 3, f"{name}: step count")
        out[name] = {"init_bitwise": True,
                     "losses_card": lc.tolist(), "losses_cpu": lh.tolist(),
                     "max_abs_err_state": worst, "worst_tensor": worst_name,
                     "tensors": len(want)}
        del side, card_state, cpu_state
    emit({"training_vs_cpu": {"customers": SMALL_CUSTOMERS,
                              "articles": SMALL_ARTICLES, "B": TRAIN_B,
                              "rtol": TRAIN_RTOL, "atol": TRAIN_ATOL,
                              "paths": out}})


def train_step_bound(model, batches, tc):
    """Least time of one step at these batches: (ms, what bounds it, ms of
    the operations at the fp32 peak). Bytes: each batch column and gathered
    row read once; the sparse path reads and writes each touched row of a
    table and its accumulator once (unique ids of this run's batches,
    averaged), the dense path writes a gradient of every parameter and reads
    it with the parameter and its state, writing both back. Operations: the
    towers' products and Q @ Cᵀ, forward and two backward products each."""
    from hm_retrieval_tpu_torch.models.train_path import uses_sparse_step

    sparse = uses_sparse_step(tc)
    adam = tc.optimizer_name.lower() == "adam"
    state_bufs = 2 if adam else 1
    m_neg = tc.num_uniform_negatives
    nbytes = sum(v.nbytes for v in batches[0].values())
    tables = {}
    for tower in (model.query_tower, model.candidate_tower):
        for f in tower.features:
            table = tower.embeddings[f.name]
            rows = TRAIN_B * (f.max_len or 1)
            if tower is model.candidate_tower:
                rows += m_neg
            nbytes += rows * table.shape[1] * 4  # gathered rows
            tables[f.name] = table
    params = dict(model.named_parameters())
    dense_floats = sum(p.numel() for n, p in params.items()
                       if ".embeddings." not in n)
    table_floats = sum(t.numel() for t in tables.values())
    if sparse:
        touched = sum(
            np.mean([len(np.unique(b[f])) for b in batches])
            * tables[f].shape[1] for f in tables)
        nbytes += 4 * touched * 4  # table and accumulator rows, in and out
        opt_floats = dense_floats
    else:
        opt_floats = dense_floats + table_floats
    # gradient written, then gradient, parameter and state read, parameter
    # and state written
    nbytes += opt_floats * 4 * (1 + 1 + 1 + state_bufs + 1 + state_bufs)
    flops = 0
    for tower, n in ((model.query_tower, TRAIN_B),
                     (model.candidate_tower, TRAIN_B + m_neg)):
        flops += sum(2 * n * layer.weight.numel() for layer in tower.dense)
    flops += 2 * TRAIN_B * (TRAIN_B + m_neg) * E
    flops *= 3  # forward, and the two products of the backward
    ms, by = roofline_ms(nbytes, flops)
    return ms, by, flops / FP32_FLOPS * 1e3, nbytes, flops


def profile_steps(step_fn, state, dev_batches, steps_per_call=1):
    """Calls over ``dev_batches`` under torch.profiler: the window's wall ms
    a step, device ms a step, the share of the window the card ran nothing,
    device operations a step and the top device operations by time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for b in dev_batches:
            state, _ = step_fn(state, b)
        sync_all()
        wall_ms = (time.perf_counter() - start) * 1e3
    spans = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in spans:
        by_name.setdefault(e.name, [0, 0.0])
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    n = len(dev_batches) * steps_per_call
    busy = sum(ms for _, ms in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    out = {
        "steps": n, "wall_ms": wall_ms / n, "device_ms": busy / n,
        "idle_share": 1 - busy / wall_ms if spans else None,
        "device_ops_per_step": len(spans) / n,
        "top_ops": [{"name": k[:90], "per_step": c / n, "ms_per_step": ms / n}
                    for k, (c, ms) in top],
    }
    by_card = {}
    for e in spans:
        by_card[e.device_index] = (by_card.get(e.device_index, 0.0)
                                   + e.time_range.elapsed_us() / 1e3)
    if len(by_card) > 1:  # several cards: each one's busy ms and idle share
        out["by_card"] = {c: {"device_ms": ms / n,
                              "idle_share": 1 - ms / wall_ms}
                          for c, ms in sorted(by_card.items())}
    return state, out


def run_training_path(name, fields, history, shards, catalog_cols, logq, dev):
    """One path at full H&M width, through the entry points a trainer
    calls: ``make_single_device_trainer``, then
    ``ShardDataset.iter_batches(shuffle) -> device_feed -> step`` (chunked:
    ``device_feed_chunked -> make_chunked_train_step``). TRAIN_WARMUP
    untimed steps, one of them under ``set_sync_debug_mode("error")``, then
    TRAIN_STEPS timed steps; the same steps again on batches already on the
    card; a profiled window. The loss must be finite on every step and lower
    at the end than at the start; on the sparse paths every table row and
    accumulator row no batch touched must be bit-unchanged."""
    from hm_retrieval_tpu_torch.data import (
        ShardDataset, device_feed, device_feed_chunked,
        make_chunked_train_step,
    )
    from hm_retrieval_tpu_torch.models import make_single_device_trainer
    from hm_retrieval_tpu_torch.models.mixed_negatives import CandidateCatalog
    from hm_retrieval_tpu_torch.models.sparse_optimizer import SparseTrainState

    tc = training_config(fields)
    t0 = time.perf_counter()
    model = train_model(N_CUSTOMERS, N_ARTICLES, logq, history, dev)
    catalog = (CandidateCatalog(catalog_cols, device=dev)
               if tc.num_uniform_negatives else None)
    state, step = make_single_device_trainer(model, tc, catalog)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    sparse = isinstance(state, SparseTrainState)
    before = {}
    if sparse:
        before = {n: (state.params[n].detach().clone(), acc.clone())
                  for n, acc in state.sparse_state.accumulators.items()}
    k = tc.steps_per_dispatch
    n_batches = TRAIN_WARMUP + TRAIN_STEPS
    host = []

    def recorded(batches):
        for b in batches:
            host.append(b)
            yield b

    batches = recorded(itertools.islice(
        ShardDataset(str(shards)).iter_batches(
            TRAIN_B, tc.shuffle_buffer_size, seed=tc.seed,
            drop_remainder=True),
        n_batches))
    if k > 1:
        feed = device_feed_chunked(batches, k, device=dev)
        fn = make_chunked_train_step(step)
    else:
        feed, fn = device_feed(batches, device=dev), step
    warm_calls = max(2, TRAIN_WARMUP // k)
    timed_steps = n_batches - warm_calls * k
    losses, starts, ends = [], [], []
    for i, b in enumerate(feed):
        if i == warm_calls - 1:  # a warm step must not sync the host
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                state, m = fn(state, b)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        else:
            if i == warm_calls:
                torch.cuda.synchronize()
                wall0 = time.perf_counter()
            if i >= warm_calls:
                starts.append(torch.cuda.Event(enable_timing=True))
                ends.append(torch.cuda.Event(enable_timing=True))
                starts[-1].record()
            state, m = fn(state, b)
            if i >= warm_calls:
                ends[-1].record()
        losses.append(m["losses"] if k > 1 else m["loss"][None])
    torch.cuda.synchronize()
    fed_ms = (time.perf_counter() - wall0) * 1e3 / timed_steps
    event_ms = [s.elapsed_time(e) / k for s, e in zip(starts, ends)]
    losses = torch.cat(losses).cpu().numpy()
    require(len(losses) == n_batches, f"{name}: {len(losses)} steps ran")
    require(bool(np.isfinite(losses).all()), f"{name}: a loss is not finite")
    require(losses[-5:].mean() < losses[:5].mean(),
            f"{name}: the loss did not fall ({losses[:5]} -> {losses[-5:]})")

    # the same steps on batches already on the card: what the feed costs
    timed = host[warm_calls * k:]
    if k > 1:
        timed = [{c: np.stack([b[c] for b in timed[j:j + k]]) for c in timed[0]}
                 for j in range(0, len(timed), k)]
    on_card = [to_device(b, dev) for b in timed]
    torch.cuda.synchronize()
    wall0 = time.perf_counter()
    for b in on_card:
        state, _ = fn(state, b)
    torch.cuda.synchronize()
    on_card_ms = (time.perf_counter() - wall0) * 1e3 / timed_steps
    state, prof = profile_steps(fn, state, on_card[:max(1, 3 // k)], k)

    untouched = {}
    for table, (p0, a0) in before.items():
        feature = table.split(".")[-1]
        mask = torch.ones(p0.shape[0], dtype=torch.bool, device=dev)
        ids = np.unique(np.concatenate([b[feature].reshape(-1) for b in host]))
        mask[torch.from_numpy(ids).to(dev).long()] = False
        p1 = state.params[table].detach()
        a1 = state.sparse_state.accumulators[table]
        require(torch.equal(p1[mask], p0[mask]) and torch.equal(a1[mask],
                                                                 a0[mask]),
                f"{name}: an untouched row of {table} changed")
        touched = ~mask
        touched[0] = False  # OOV / pad row
        moved = (a1[touched] != a0[touched]).any(dim=1)
        require(bool(moved.any()), f"{name}: no touched row of {table} moved")
        untouched[table] = {"untouched_rows": int(mask.sum()),
                            "touched_rows": int(touched.sum()),
                            "touched_rows_moved": int(moved.sum())}
    bound_ms, bound_by, fp32_ops_ms, nbytes, flops = train_step_bound(
        model, host, tc)
    median_ms = statistics.median(event_ms)
    row = {
        "path": name, "B": TRAIN_B, "sparse": sparse,
        "optimizer": tc.optimizer_name, "history_len": HISTORY_LEN * history,
        "uniform_negatives": tc.num_uniform_negatives,
        "steps_per_call": k, "timed_steps": timed_steps, "setup_s": setup_s,
        "median_step_ms": median_ms, "min_step_ms": min(event_ms),
        "max_step_ms": max(event_ms),
        "examples_per_s": TRAIN_B / median_ms * 1e3,
        "fed_wall_ms_per_step": fed_ms, "on_card_wall_ms_per_step": on_card_ms,
        "feed_cost_ms_per_step": fed_ms - on_card_ms,
        "loss_first5": losses[:5].tolist(), "loss_last5": losses[-5:].tolist(),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "fp32_ops_ms": fp32_ops_ms, "bytes": nbytes, "flops": flops,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile": prof, "untouched": untouched, "sync_free_step": True,
    }
    emit({"training": row})
    return row


def phase_training_determinism(shards, logq, dev):
    """At full width, 3 sparse and 3 dense Adagrad steps replayed twice from
    one saved state: tables, accumulators, dense params and losses must be
    bit-identical."""
    from hm_retrieval_tpu_torch.data import ShardDataset
    from hm_retrieval_tpu_torch.models import make_single_device_trainer

    host = list(itertools.islice(ShardDataset(str(shards)).iter_batches(
        TRAIN_B, 0, drop_remainder=True), 3))
    batches = [to_device(b, dev) for b in host]
    out = {}
    for name, fields in (("sparse_adagrad", {}),
                         ("dense_adagrad",
                          {"use_sparse_embedding_optimizer": False})):
        model = train_model(N_CUSTOMERS, N_ARTICLES, logq, False, dev)
        state, step = make_single_device_trainer(model,
                                                 training_config(fields), None)
        saved = {n: t.detach().clone() for n, t in state_tensors(state).items()}
        runs = []
        for _ in range(2):
            with torch.no_grad():
                for n, t in state_tensors(state).items():
                    t.copy_(saved[n])
            losses = []
            for b in batches:
                state, m = step(state, b)
                losses.append(m["loss"])
            runs.append(({n: t.detach().clone()
                          for n, t in state_tensors(state).items()},
                         torch.stack(losses)))
        (s1, l1), (s2, l2) = runs
        require(torch.equal(l1, l2), f"{name}: replayed losses differ")
        differ = [n for n in s1 if not torch.equal(s1[n], s2[n])]
        require(not differ, f"{name}: replay differs in {differ}")
        changed = sum(not torch.equal(s1[n], saved[n]) for n in s1)
        out[name] = {"tensors": len(s1), "changed_by_the_steps": changed,
                     "losses": l1.tolist()}
        del model, state, saved, runs, s1, s2
        torch.cuda.empty_cache()
    emit({"training_determinism": out})


def phase_training_chunk_pairs(shards, logq, dev, rounds=8):
    """CHUNK_K single sparse steps against one chunked call of the same
    steps on the same batches already on the card, in turns (which runs
    first alternates): wall ms a step, synchronized, each round."""
    from hm_retrieval_tpu_torch.data import (
        ShardDataset, make_chunked_train_step,
    )
    from hm_retrieval_tpu_torch.models import make_single_device_trainer

    host = list(itertools.islice(ShardDataset(str(shards)).iter_batches(
        TRAIN_B, 0, drop_remainder=True), CHUNK_K))
    model = train_model(N_CUSTOMERS, N_ARTICLES, logq, False, dev)
    state, step = make_single_device_trainer(model, training_config({}),
                                             None)
    singles = [to_device(b, dev) for b in host]
    stacked = to_device({c: np.stack([b[c] for b in host]) for c in host[0]},
                        dev)
    chunk_step = make_chunked_train_step(step)

    def run_single(s):
        for b in singles:
            s, _ = step(s, b)
        return s

    def run_chunked(s):
        return chunk_step(s, stacked)[0]

    runs = [("single", run_single), ("chunked", run_chunked)]
    for _, fn in runs * 2:  # warm-up
        state = fn(state)
    ms = {"single": [], "chunked": []}
    for r in range(rounds):
        for name, fn in runs if r % 2 == 0 else runs[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = fn(state)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3 / CHUNK_K)
    emit({"training_chunk_pairs": {
        "steps": CHUNK_K, "rounds": rounds, **{f"{n}_ms": v for n, v in
                                               ms.items()},
        **{f"{n}_median_ms": statistics.median(v) for n, v in ms.items()},
        "chunked_faster_rounds": sum(c < s for s, c in zip(ms["single"],
                                                           ms["chunked"]))}})


def phase_training(seed, dev, workdir):
    """Phase 9 (see the module docstring)."""
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt

    require(not torch.backends.cuda.matmul.allow_tf32
            and torch.get_float32_matmul_precision() == "highest",
            "TF32 is on: the towers must run fp32")
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    probs, logq = article_popularity(N_ARTICLES)
    rows, catalog_cols = train_columns(rng, TRAIN_ROWS, N_CUSTOMERS,
                                       N_ARTICLES, probs)
    shards = workdir / "train_shards"
    write_shards(shards, rows)
    emit({"training_setup": {"rows": TRAIN_ROWS, "shards": -(-TRAIN_ROWS //
                                                            SHARD_ROWS),
                             "seconds": time.perf_counter() - t0}})
    phase_training_vs_cpu(dev)
    torch.cuda.empty_cache()
    # --- the main path: counts from 0; training launches no bin-max kernel
    bt.reset_launches()
    qt.reset_launches()
    rows_out = []
    for name, fields, history in TRAIN_PATHS:
        torch.cuda.reset_peak_memory_stats()
        rows_out.append(run_training_path(name, fields, history, shards,
                                          catalog_cols, logq, dev))
        torch.cuda.empty_cache()
    launches = {**bt.LAUNCHES, **qt.LAUNCHES}
    # ----------------------------------------------------------------------
    require(set(launches.values()) == {0},
            f"training launched bin-max kernels: {launches}")
    phase_training_determinism(shards, logq, dev)
    phase_training_chunk_pairs(shards, logq, dev)
    torch.cuda.empty_cache()
    return rows_out


# --- phase 10: the modelling runner -----------------------------------------
RUNNER_TRAIN_ROWS = 128 * TRAIN_B  # one epoch of 128 steps
RUNNER_TEST_ROWS = 8 * 2048  # 8 batches at TrainingConfig's test_batch_size
RUNNER_CHECKED_BATCHES = 2  # test batches held against the plain passes
# Article i of the stream is H&M's article id HM_ARTICLE_BASE + i, written
# zero-padded to 10 digits in the transactions CSV as H&M writes it
# ("0108775015"): read back as integers, as pandas reads them (trap j)
HM_ARTICLE_BASE = 108_775_014
TRAIN_DAYS, TEST_DAYS = 45, 7
TRAIN_START, TEST_START = np.datetime64("2020-08-01"), np.datetime64("2020-09-15")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def runner_settings(rng, n_customers, n_articles, workdir):
    """The runner's inputs: bench.py's H&M schema (ks 10, 100, 1000 and
    TrainingConfig's defaults) with phase 9's logQ, saved with the port's
    ``Schema.save``; train, test and candidate shards written with phase 9's
    writer. Train and test are consecutive rows of one learnable stream, so
    the test rows are held out from the same customers' purchases."""
    from hm_retrieval_tpu_torch.utils import Settings

    probs, logq = article_popularity(n_articles)
    rows, catalog = train_columns(rng, RUNNER_TRAIN_ROWS + RUNNER_TEST_ROWS,
                                  n_customers, n_articles, probs)
    rows.pop("purchase_history")
    write_shards(workdir / "train",
                 {k: v[:RUNNER_TRAIN_ROWS] for k, v in rows.items()})
    write_shards(workdir / "test",
                 {k: v[RUNNER_TRAIN_ROWS:] for k, v in rows.items()})
    write_shards(workdir / "candidates", catalog)
    write_transactions(workdir / "transactions.csv", rows["article_id"])
    article_vocab = np.array([str(HM_ARTICLE_BASE + i)
                              for i in range(1, n_articles + 1)])
    hm_schema(n_customers, n_articles, logq,
              article_vocab).save(str(workdir / "schema"))
    return Settings(
        transactions_filepath=str(workdir / "transactions.csv"),
        train_start_date=str(TRAIN_START),
        train_end_date=str(TRAIN_START + TRAIN_DAYS - 1),
        test_start_date=str(TEST_START),
        test_end_date=str(TEST_START + TEST_DAYS - 1),
        baseline_index_dirpath=str(workdir / "baseline_index"),
        schema_dirpath=str(workdir / "schema"),
        train_shards_dirpath=str(workdir / "train"),
        test_shards_dirpath=str(workdir / "test"),
        candidate_shards_dirpath=str(workdir / "candidates"),
        model_dirpath=str(workdir / "model"),
        index_dirpath=str(workdir / "index"),
        checkpoint_dirpath=str(workdir / "checkpoints"),
        tensorboard_logs_dir=str(workdir / "logs"),
    )  # profile_steps: the default trace window, steps 20-40


def stream_dates(n_train, n_test):
    """t_dat of the stream's rows: the train rows spread over TRAIN_DAYS
    from TRAIN_START, the test rows over TEST_DAYS from TEST_START."""
    train = TRAIN_START + (np.arange(n_train) * TRAIN_DAYS) // n_train
    test = TEST_START + (np.arange(n_test) * TEST_DAYS) // n_test
    return np.concatenate([train, test]).astype(str)


def write_transactions(path, articles):
    """The stream as a transactions CSV (t_dat, article_id), in row order,
    each article written as its zero-padded H&M id."""
    dates = stream_dates(RUNNER_TRAIN_ROWS, RUNNER_TEST_ROWS)
    with open(path, "w") as f:
        f.write("t_dat,article_id\n")
        f.writelines(f"{d},{HM_ARTICLE_BASE + int(a):010d}\n"
                     for d, a in zip(dates, articles))


@contextlib.contextmanager
def host_copies():
    """Inside the block, every copy of a tensor from the card to the host
    (``.cpu()``, ``.to(...)``, ``.tolist()``, ``.copy_`` into a host tensor)
    is recorded as (method, shape, elements)."""
    seen = []
    saved = {name: getattr(torch.Tensor, name)
             for name in ("cpu", "to", "tolist", "copy_")}

    def wrap(name):
        original = saved[name]

        def method(self, *args, **kwargs):
            out = original(self, *args, **kwargs)
            if name == "copy_":
                src = args[0] if args else kwargs["src"]
                moved = self.device.type == "cpu" and src.device.type != "cpu"
            else:
                src = self
                moved = self.device.type != "cpu" and (
                    name == "tolist" or out.device.type == "cpu")
            if moved:
                seen.append((name, tuple(src.shape), src.numel()))
            return out
        return method

    for name in saved:
        setattr(torch.Tensor, name, wrap(name))
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def profile_eval_batch(model, index, batch, dev):
    """One evaluate batch (query tower, top-k, metric) under torch.profiler:
    wall ms, device ms, idle share, device operations."""
    from torch.profiler import ProfilerActivity, profile

    from hm_retrieval_tpu_torch.metrics import IndexRecall

    metric = IndexRecall([10, 100, SERVE_K])
    sync(dev)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with torch.no_grad(), profile(activities=activities) as prof:
        start = time.perf_counter()
        q = model.query_forward(batch)
        _, ids = index.topk_from_embeddings(q)
        metric.update(ids, batch["article_id"])
        sync(dev)
        wall_ms = (time.perf_counter() - start) * 1e3
    spans = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in spans) / 1e3
    return {"wall_ms": wall_ms, "device_ms": busy,
            "idle_share": 1 - busy / wall_ms if spans else None,
            "device_ops": len(spans)}


def trace_reading(settings, dev):
    """The runner's profiler trace over its default window: the file must
    exist and, on the card, hold the card's kernels."""
    path = Path(settings.tensorboard_logs_dir,
                f"trace_from_step_{settings.profile_steps[0]}.json")
    require(path.exists(), f"no profiler trace at {path}")
    events = json.loads(path.read_text())["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    require(dev.type != "cuda" or kernels > 0,
            "the profiler trace holds no kernel of the card")
    return {"file": path.name, "bytes": path.stat().st_size,
            "events": len(events), "kernel_events": kernels}


def check_runner_recall(name, res, ks):
    require(set(res) == set(ks), f"{name}: recall at {sorted(res)}")
    require(all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in res.values()),
            f"{name}: a recall outside [0, 1]: {res}")


def hold_exact_path(model, index, test_ds, tc, dev):
    """The exact index's answers on the first test batches against the same
    index with exact_topk's kernels swapped for their plain versions: values
    within TOL·max(1, |s|), ids swapped only between scores within it, and
    equal recall counts."""
    from hm_retrieval_tpu_torch.metrics import IndexRecall
    from hm_retrieval_tpu_torch.ops import bin_topk as bt

    n = index.num_candidates
    require(torch.equal(index.identifiers[:n].cpu(),
                        torch.arange(1, n + 1, dtype=torch.int32)),
            "the catalog is not articles 1..N in order")
    cb = index.embeddings[:n].to(torch.bfloat16)
    plain = {
        "bin_max2_first_round": lambda q, c, L, nv: bt.bin_max2_plain(
            q, c, L, nv),
        "bin_max2_round": lambda q, c, ts, ti, L, nv: bt.bin_max2_plain(
            q, c, L, nv, ts, ti),
    }
    worst, mismatches, recalls = 0.0, 0, []
    batches = itertools.islice(test_ds.iter_batches(tc.test_batch_size),
                               RUNNER_CHECKED_BATCHES)
    for b in batches:
        tb = to_device(b, dev)
        with torch.no_grad():
            q = model.query_forward(tb)
        got_v, got_ids = index.topk_from_embeddings(q)
        with swapped(bt, **plain):
            want_v, want_ids = index.topk_from_embeddings(q)
        scores = bt.plain_scores(q.to(torch.bfloat16), cb)
        finite = torch.isfinite(want_v)
        require(bool(finite.all()) and bool(torch.isfinite(got_v).all()),
                "an unfilled slot in the exact answers")
        err = (got_v - want_v).abs()
        require(bool((err <= TOL * want_v.abs().clamp_min(1.0)).all()),
                f"exact values outside TOL, max err {float(err.max())}")
        diff = got_ids != want_ids
        rows = diff.nonzero()[:, 0]
        s_got = scores[rows, (got_ids[diff] - 1).long()]
        s_want = scores[rows, (want_ids[diff] - 1).long()]
        require(bool(((s_got - s_want).abs()
                      <= TOL * s_want.abs().clamp_min(1.0)).all()),
                "exact ids differ between well-separated scores")
        counts = []
        for ids in (got_ids, want_ids):
            metric = IndexRecall([10, 100, SERVE_K])
            metric.update(ids, tb["article_id"])
            counts.append(metric.hits.tolist())
        require(counts[0] == counts[1],
                f"recall counts differ: kernels {counts[0]}, plain {counts[1]}")
        worst = max(worst, float(err.max()))
        mismatches += int(diff.sum())
        recalls.append(counts[0])
    return {"batches": RUNNER_CHECKED_BATCHES, "B": tc.test_batch_size,
            "max_abs_err": worst, "id_mismatches": mismatches,
            "hits_at_10_100_1000": recalls, "tol": TOL}


def hold_quantized_path(model, qindex, test_ds, tc, dev):
    """The quantized index's single pass on the first test batches, at the
    B, plan and inputs evaluate gives it, against its plain version: the
    pass's (B, L) cells within TOL, ids differing only between pass scores
    within 2*TOL; the answers with the plain pass swapped in bit-equal on
    every row where the two passes keep the same survivors; equal recall
    counts over the batch. Rows whose survivors differ (only by near ties,
    by the cells' check) are counted."""
    from hm_retrieval_tpu_torch.metrics import IndexRecall

    worst, mismatches, other, recalls = 0.0, 0, 0, []
    batches = itertools.islice(test_ds.iter_batches(tc.test_batch_size),
                               RUNNER_CHECKED_BATCHES)
    for b in batches:
        tb = to_device(b, dev)
        with torch.no_grad():
            q = model.query_forward(tb)
        with recorded_passes(plain=False) as rec_k:
            got_v, got_ids = qindex.topk_from_embeddings(q)
        with recorded_passes(plain=True) as rec_p:
            want_v, want_ids = qindex.topk_from_embeddings(q)
        require(len(rec_k) == 1 and len(rec_p) == 1,
                f"{len(rec_k)} passes a batch, plain {len(rec_p)}")
        qp, c, sc, bi, kout = rec_k[0]
        require(qp.shape[0] == tc.test_batch_size,
                f"the pass ran at B = {qp.shape[0]}")
        pout = rec_p[0][4]
        scores = pass_scores(qp, c, sc, bi)
        for vi, ii in ((0, 1), (2, 3)):
            e, m = compare_ranked(kout[vi], kout[ii], pout[vi], pout[ii],
                                  scores)
            worst, mismatches = max(worst, e), mismatches + m
        del scores
        same = ~((kout[1] != pout[1]) | (kout[3] != pout[3])).any(1)
        require(torch.equal(got_v[same], want_v[same])
                and torch.equal(got_ids[same], want_ids[same]),
                "quantized answers differ from the plain pass's where the "
                "survivors agree")
        counts = []
        for ids in (got_ids, want_ids):
            metric = IndexRecall([10, 100, SERVE_K])
            metric.update(ids, tb["article_id"])
            counts.append(metric.hits.tolist())
        require(counts[0] == counts[1], f"quantized recall counts differ: "
                f"kernel {counts[0]}, plain {counts[1]}")
        other += int((~same).sum())
        recalls.append(counts[0])
    return {"batches": RUNNER_CHECKED_BATCHES, "B": tc.test_batch_size,
            "max_abs_err": worst, "id_mismatches": mismatches,
            "rows_with_other_survivors": other,
            "hits_at_10_100_1000": recalls, "tol": TOL}


def phase_runner(seed, dev, workdir, n_customers=N_CUSTOMERS,
                 n_articles=N_ARTICLES):
    """Phase 10 (see the module docstring). Returns each kernel's launches
    in the two paths driven from 0: the runner, then the quantized
    family's build_index + evaluate."""
    from hm_retrieval_tpu_torch.data import ShardDataset
    from hm_retrieval_tpu_torch.indices.builder import collect_catalog_device
    from hm_retrieval_tpu_torch.models import TwoTowerModel
    from hm_retrieval_tpu_torch.models.train_path import (
        create_single_device_state,
    )
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt
    from hm_retrieval_tpu_torch.runners import (
        CheckpointManager, build_index, evaluate, evaluation_runner,
        modelling_runner,
    )
    from hm_retrieval_tpu_torch.schema import Schema

    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    settings = runner_settings(np.random.default_rng(seed), n_customers,
                               n_articles, workdir)
    setup_s = time.perf_counter() - t0
    log = Records(logging.INFO)
    runner_log = logging.getLogger("hm_retrieval_tpu_torch.runners.modelling")
    level = runner_log.level
    runner_log.setLevel(logging.INFO)
    runner_log.addHandler(log)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    # --- the main path: the runner, counts from 0 -------------------------
    bt.reset_launches()
    qt.reset_launches()
    t0 = time.perf_counter()
    try:
        results = modelling_runner(settings, device=dev)
    finally:
        runner_log.removeHandler(log)
        runner_log.setLevel(level)
    runner_s = time.perf_counter() - t0
    runner_launches = {**bt.LAUNCHES, **qt.LAUNCHES}
    # ----------------------------------------------------------------------
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    schema = Schema.load(settings.schema_dirpath)
    tc, mc = schema.training_config, schema.model_config
    for name in ("initial", "final"):
        check_runner_recall(name, results[name], mc.ks)
    require(results["final"][100] > results["initial"][100],
            f"recall@100 did not rise: {results}")
    # (on the CPU, where the phase can be rehearsed small, nothing launches)
    require(not cuda or (runner_launches["bin_max2_first_round"] > 0
                         and runner_launches["bin_max2_round"] > 0),
            f"evaluate did not launch kernels 1-2: {runner_launches}")
    require(all(v == 0 for k, v in runner_launches.items()
                if k not in ("bin_max2_first_round", "bin_max2_round")),
            f"the runner launched other kernels: {runner_launches}")
    steps = RUNNER_TRAIN_ROWS // tc.train_batch_size
    ckpt = CheckpointManager(settings.checkpoint_dirpath, device=dev)
    require(ckpt.latest_step() == steps,
            f"checkpoint at step {ckpt.latest_step()}, not {steps}")
    for path in ("two_tower", "query_tower", "candidate_tower"):
        require(Path(settings.model_dirpath, path, "params.npz").exists(),
                f"no exported {path}")
    require(Path(settings.index_dirpath, "index.npz").exists(),
            "no index artifact")
    throughput = [float(m.split()[2]) for m in log.records
                  if m.startswith("Training throughput")]
    require(len(throughput) == 1, f"throughput lines: {throughput}")
    trace = trace_reading(settings, dev)

    # --- eval only, from the checkpoint: equal to the runner's final -------
    t0 = time.perf_counter()
    eval_only = evaluation_runner(settings, device=dev)
    eval_runner_s = time.perf_counter() - t0
    require(eval_only == results["final"],
            f"evaluation_runner {eval_only} != final {results['final']}")

    # --- the restored model: checkpoint, build and evaluate times ---------
    model = TwoTowerModel.create_from_schema(schema, device=dev)
    state = create_single_device_state(model, tc)
    sync(dev)
    t0 = time.perf_counter()
    state = ckpt.restore(state)
    sync(dev)
    restore_ms = (time.perf_counter() - t0) * 1e3
    ckpt.close()
    timing = CheckpointManager(str(workdir / "checkpoint_timing"), device=dev)
    t0 = time.perf_counter()
    timing.save(state.step, state)
    save_copy_ms = (time.perf_counter() - t0) * 1e3
    timing.wait_until_finished()
    save_ms = (time.perf_counter() - t0) * 1e3
    ckpt_bytes = (workdir / "checkpoint_timing" / str(state.step)
                  / "state.npz").stat().st_size
    timing.close()
    shutil.rmtree(workdir / "checkpoint_timing")

    cand_ds = ShardDataset(settings.candidate_shards_dirpath)
    test_ds = ShardDataset(settings.test_shards_dirpath)
    k = min(max(mc.ks), cand_ds.num_rows)
    cbs = tc.candidate_batch_size
    sync(dev)
    t0 = time.perf_counter()
    with host_copies() as build_copies:
        index = build_index(model, cand_ds, cbs, k, device=dev)
        sync(dev)
    build_ms = (time.perf_counter() - t0) * 1e3
    # in all, less than one candidate batch's embeddings may reach the host
    build_moved = sum(n for *_, n in build_copies)
    require(build_moved < cbs * E, f"the build copied {build_moved} "
            f"elements to the host: {build_copies}")
    require(index.method == "pallas" and index._engine == "pallas",
            f"the exact index runs {index._engine!r}")
    n_batches = -(-test_ds.num_rows // tc.test_batch_size)
    t0 = time.perf_counter()
    exact = evaluate(model, index, test_ds, tc.test_batch_size, mc.ks)
    eval_ms = (time.perf_counter() - t0) * 1e3
    require(exact == results["final"],
            f"the restored model's recall {exact} != final {results['final']}")
    t0 = time.perf_counter()
    index.save(str(workdir / "index_timing"))
    index_save_ms = (time.perf_counter() - t0) * 1e3
    first = to_device(next(test_ds.iter_batches(tc.test_batch_size)), dev)
    eval_profile = profile_eval_batch(model, index, first, dev)

    def embed(batch):
        return model.candidate_forward(to_device(batch, dev))

    with host_copies() as copies:
        ids, emb = collect_catalog_device(model.candidate_id_col, embed,
                                          cand_ds.iter_batches(cbs), cbs)
    require(emb.device == index.embeddings.device
            and tuple(emb.shape) == (n_articles, E)
            and sum(n for *_, n in copies) < cbs * E,
            f"collect_catalog_device: {emb.device}, {tuple(emb.shape)}, "
            f"host copies {copies}")
    del emb

    # --- kernels 1-2 against their plain versions on this path ------------
    held = hold_exact_path(model, index, test_ds, tc, dev)

    # --- the quantized family: a reading ----------------------------------
    t0 = time.perf_counter()
    qindex = build_index(model, cand_ds, cbs, k, index_type="quantized",
                         device=dev)
    sync(dev)
    qbuild_ms = (time.perf_counter() - t0) * 1e3
    require(qindex._engine == "pallas", f"quantized runs {qindex._engine!r}")
    # --- the quantized path: counts from 0 --------------------------------
    bt.reset_launches()
    qt.reset_launches()
    t0 = time.perf_counter()
    quantized = evaluate(model, qindex, test_ds, tc.test_batch_size, mc.ks)
    q_eval_ms = (time.perf_counter() - t0) * 1e3
    q_launches = {**bt.LAUNCHES, **qt.LAUNCHES}
    # ----------------------------------------------------------------------
    check_runner_recall("quantized", quantized, mc.ks)
    single = {n: q_launches[n] for n in SINGLE_PASS_KERNELS[:2]}
    require(not cuda or sum(single.values()) > 0,
            f"the quantized evaluate launched no single pass: {q_launches}")
    # --- kernels 3-4 against their plain versions on this path ------------
    q_held = hold_quantized_path(model, qindex, test_ds, tc, dev)
    emit({"runner": {
        "catalog": n_articles, "customers": n_customers, "E": E,
        "train_rows": RUNNER_TRAIN_ROWS, "test_rows": RUNNER_TEST_ROWS,
        "steps": steps, "setup_s": setup_s, "runner_s": runner_s,
        "initial": results["initial"], "final": results["final"],
        "train_examples_per_s": throughput[0],
        "profiler_window": list(settings.profile_steps), "trace": trace,
        "runner_launches": runner_launches,
        "eval_runner_s": eval_runner_s, "eval_runner_equals_final": True,
        "build_index_ms": build_ms, "build_host_copies": len(build_copies),
        "build_host_elements": build_moved,
        "evaluate_ms": eval_ms, "test_batches": n_batches,
        "evaluate_ms_per_batch": eval_ms / n_batches,
        "eval_batch_profile": eval_profile,
        "checkpoint_bytes": ckpt_bytes, "checkpoint_save_ms": save_ms,
        "checkpoint_save_copy_ms": save_copy_ms,
        "checkpoint_restore_ms": restore_ms, "index_save_ms": index_save_ms,
        "peak_mem_gb": peak_gb, "exact_vs_plain": held,
        "quantized": {"recall": quantized, "exact_recall": exact,
                      "k_over": qindex.k_over, "build_ms": qbuild_ms,
                      "evaluate_ms": q_eval_ms,
                      "single_pass_launches": single,
                      "launches": q_launches, "vs_plain": q_held}}})
    launches = {name: runner_launches[name] + q_launches[name]
                for name in runner_launches}
    return launches, {"settings": settings, "initial": results["initial"],
                      "final": results["final"],
                      "model": model, "index": index, "qindex": qindex,
                      "test_ds": test_ds, "tc": tc, "mc": mc}


# --- phase 11: the popularity baseline -------------------------------------


def popularity_reference(articles):
    """The popularity order counted directly: count descending, ties in
    order of first appearance."""
    uniq, first, counts = np.unique(articles, return_index=True,
                                    return_counts=True)
    return uniq[np.lexsort((first, -counts))]


def phase_baseline(ctx, dev):
    """Phase 11 (see the module docstring)."""
    from hm_retrieval_tpu_torch.data import ShardDataset
    from hm_retrieval_tpu_torch.indices import StaticIndex, load_index
    from hm_retrieval_tpu_torch.runners import baseline_modelling_runner

    settings, mc = ctx["settings"], ctx["mc"]
    t0 = time.perf_counter()
    res = baseline_modelling_runner(settings, device=dev)
    sync(dev)
    seconds = time.perf_counter() - t0
    check_runner_recall("baseline", res, mc.ks)
    index = load_index(settings.baseline_index_dirpath, device=dev)
    require(isinstance(index, StaticIndex)
            and index.identifiers.device.type == dev.type,
            f"the static artifact loads as {type(index).__name__}")
    k = max(mc.ks)
    train = ShardDataset(settings.train_shards_dirpath).load_all()["article_id"]
    want = popularity_reference(train)[:k]
    got = index.identifiers.cpu().numpy()
    require(len(got) == k and np.array_equal(got, want),
            "the popularity index is not the train rows' k most popular "
            "articles (the CSV's zero-padded ids read as integers)")
    test = ShardDataset(settings.test_shards_dirpath).load_all()["article_id"]
    plain = {kk: float(np.isin(test, want[:kk]).mean()) for kk in mc.ks}
    require(all(abs(res[kk] - plain[kk]) <= 1e-9 for kk in mc.ks),
            f"baseline recall {res} != counted {plain}")
    emit({"baseline": {"recall": res, "trained_final_recall": ctx["final"],
                       "index_k": int(len(got)), "train_rows": int(len(train)),
                       "test_rows": int(len(test)), "seconds": seconds}})


# --- phase 12: the sharded serving index ------------------------------------

SHARDS = 4  # model shards of phase 12's mesh, all on the one card
PAD_B = 37  # query rows on the (2, 2) mesh, padded to 38


def kernel_counts():
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt

    return {**bt.LAUNCHES, **qt.LAUNCHES}


def timed_ms(fn, reps, dev):
    """Device ms of ``fn`` by CUDA events on the card; wall ms elsewhere."""
    if dev.type == "cuda":
        return cuda_ms(fn, reps)
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


@contextlib.contextmanager
def plain_exact():
    """Inside the block exact_topk runs kernels 1-2's plain versions."""
    from hm_retrieval_tpu_torch.ops import bin_topk as bt

    with swapped(
        bt,
        bin_max2_first_round=lambda q, c, L, nv: bt.bin_max2_plain(q, c, L, nv),
        bin_max2_round=lambda q, c, ts, ti, L, nv: bt.bin_max2_plain(
            q, c, L, nv, ts, ti),
    ):
        yield


@contextlib.contextmanager
def recorded_survivors():
    """Inside the block every quantized_topk call (one a shard) is recorded
    as (q, codes, scales, bias, values, rows)."""
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt

    record, driver = [], qt.quantized_topk

    def run(q, codes, scales, k, **kw):
        v, i, r = driver(q, codes, scales, k, **kw)
        record.append((q, codes, scales, kw.get("bias"), v, i))
        return v, i, r

    with swapped(qt, quantized_topk=run):
        yield record


def answers_ok(v, ids, k, n):
    """No NaN, every slot filled with a real article, k distinct a row."""
    require(not bool(torch.isnan(v).any()) and bool(torch.isfinite(v).all()),
            "a NaN or unfilled slot in a sharded answer")
    require(bool(((ids >= 1) & (ids <= n)).all()), "a pad row in an answer")
    require(all(len(set(r)) == k for r in ids.cpu().tolist()),
            "repeated articles in a sharded answer")


def hold_sharded_quantized(index, q, rounds, shards=SHARDS):
    """A sharded quantized index's answers against the same index with its
    passes' plain versions: each shard's survivors within TOL, ids
    differing only between pass scores within 2*TOL; the answers bit-equal
    on every row where all shards keep the same survivors."""
    from hm_retrieval_tpu_torch.ops import bin_topk as bt

    with recorded_survivors() as rec_k:
        got = index.topk_from_embeddings(q)
    plain = plain_rounds() if rounds else recorded_passes(plain=True)
    with recorded_survivors() as rec_p, plain:
        want = index.topk_from_embeddings(q)
    require(len(rec_k) == len(rec_p) == shards,
            f"{len(rec_k)} survivor calls, plain {len(rec_p)}")
    worst, mismatches = 0.0, 0
    same = torch.ones(q.shape[0], dtype=torch.bool, device=q.device)
    for (qs, codes, sc, bi, kv, ki), (*_, pv, pi) in zip(rec_k, rec_p):
        scores = pass_scores(qs.to(torch.bfloat16), codes, sc, bi)
        err, mism = compare_ranked(kv, ki, pv, pi, scores)
        worst, mismatches = max(worst, err), mismatches + mism
        same &= (ki == pi).all(1).to(same.device)
        del scores
    require(torch.equal(got[0][same], want[0][same])
            and torch.equal(got[1][same], want[1][same]),
            "sharded answers differ from the plain passes' where the "
            "survivors agree")
    return got, {"max_abs_err": worst, "id_mismatches": mismatches,
                 "rows_with_other_survivors": int((~same).sum())}


def recall_vs(ids, exact_ids):
    """Mean share of each row's exact top-k found in ``ids``."""
    hit = (ids.unsqueeze(2) == exact_ids.unsqueeze(1)).any(2)
    return float(hit.float().mean())


def check_pad_rows(index, q, dev):
    """The last shard's pad rows through the bias column: their fp32 scores
    of the bf16 operands are exactly -inf and the real rows' finite, and
    kernel 1 on the same operands returns no NaN and none of them."""
    from hm_retrieval_tpu_torch.ops import bin_topk as bt

    s = SHARDS - 1
    emb, bias = index._emb.shard(s), index._bias.shard(s)
    per = emb.shape[0]
    real = int(torch.isfinite(bias).sum())
    ones = torch.ones((q.shape[0], 1), device=dev)
    q_aug = torch.cat([q, ones], 1).to(torch.bfloat16)
    c_aug = torch.cat([emb, bias[:, None]], 1).to(torch.bfloat16)
    scores = bt.plain_scores(q_aug, c_aug)
    require(bool(torch.isneginf(scores[:, real:]).all())
            and bool(torch.isfinite(scores[:, :real]).all()),
            "a pad row's score is not exactly -inf")
    L = bt.default_bins(SERVE_K)
    width = bt.padded_width(E + 1)
    cells = bt.bin_max2_first_round(
        bt._padded(q_aug, q.shape[0], width),
        bt._padded(c_aug, -(-per // L) * L, width), L, per)
    require(not any(bool(torch.isnan(c).any()) for c in cells[::2]),
            "kernel 1 returned NaN over the bias column")
    for rows in cells[1::2]:
        require(not bool(((rows >= real) & (rows < per)).any()),
                "kernel 1 returned a pad row")
    return {"shard": s, "rows": per, "pad_rows": per - real, "width": width}


def phase_sharded(ctx, repeats, dev, workdir):
    """Phase 12 (see the module docstring). Returns each kernel's launches
    over the main path: the three sharded indices at every served B, the
    (2, 2) mesh at B = 37, the sharded service and evaluation_runner."""
    from hm_retrieval_tpu_torch.indices import (
        DistributedBruteForceIndex, DistributedQuantizedIndex,
        QuantizedIndex, load_distributed_index,
    )
    from hm_retrieval_tpu_torch.metrics import IndexRecall
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt
    from hm_retrieval_tpu_torch.parallel import make_mesh
    from hm_retrieval_tpu_torch.runners import evaluation_runner
    from hm_retrieval_tpu_torch.serving import RetrievalService

    settings, model, exact1 = ctx["settings"], ctx["model"], ctx["index"]
    tc, mc, test_ds = ctx["tc"], ctx["mc"], ctx["test_ds"]
    n = exact1.num_candidates
    k = SERVE_K
    ids = exact1.identifiers[:n].cpu().numpy()
    emb = exact1.embeddings[:n]
    first = to_device(next(test_ds.iter_batches(tc.test_batch_size)), dev)
    with torch.no_grad():
        q_all = model.query_forward(first)[: max(SERVE_BATCHES)]
    mesh = make_mesh(1, SHARDS, devices=[dev] * SHARDS)
    mesh22 = make_mesh(2, 2, devices=[dev] * 4)
    t0 = time.perf_counter()
    single = {
        "exact": exact1,
        "quantized": ctx["qindex"],
        "rounds": QuantizedIndex(k, ids, emb, method="pallas",
                                 pallas_rounds=MAX_ROUNDS, device=dev),
    }
    sharded = {
        "exact": DistributedBruteForceIndex(k, ids, emb, mesh=mesh,
                                            method="pallas"),
        "quantized": DistributedQuantizedIndex(k, ids, emb, mesh=mesh,
                                               method="pallas"),
        "rounds": DistributedQuantizedIndex(k, ids, emb, mesh=mesh,
                                            method="pallas",
                                            pallas_rounds=MAX_ROUNDS),
    }
    pad_index = DistributedBruteForceIndex(k, ids, emb, mesh=mesh22,
                                           method="pallas")
    sync(dev)
    build_s = time.perf_counter() - t0
    require(all(ix._engine == "pallas" for ix in sharded.values()),
            "a sharded index does not run the kernels")
    schema_dir = settings.schema_dirpath
    raw_ids = first["customer_id"][:max(SERVE_BATCHES[:-1])].cpu().tolist()
    raw = {"customer_id": [f"c{c - 1:07d}" for c in raw_ids]}
    sharded_dir = str(workdir / "index_sharded")

    # --- the main path: counts from 0 --------------------------------------
    bt.reset_launches()
    qt.reset_launches()
    per_index, answers = {}, {}
    for name, index in sharded.items():
        per_index[name], answers[name] = {}, {}
        for B in SERVE_BATCHES:
            before = kernel_counts()
            answers[name][B] = index.topk_from_embeddings(q_all[:B])
            per_index[name][B] = {kn: v - before[kn]
                                  for kn, v in kernel_counts().items()
                                  if v > before[kn]}
    padded = pad_index.topk_from_embeddings(q_all[:PAD_B])
    svc_d = RetrievalService.load(schema_dir, settings.model_dirpath,
                                  settings.index_dirpath, mesh=mesh,
                                  distributed_index=True, device=dev)
    served = svc_d.retrieve(raw)
    res_d = evaluation_runner(
        dataclasses.replace(settings, index_dirpath=sharded_dir),
        mesh=mesh, distributed_index=True, device=dev)
    sync(dev)
    launches = kernel_counts()
    # ----------------------------------------------------------------------
    cuda = dev.type == "cuda"
    want_kernels = {
        "exact": ("bin_max2_first_round", "bin_max2_round"),
        "quantized": SINGLE_PASS_KERNELS[:2],
        "rounds": ROUNDS_KERNELS,
    }
    for name, kernels in want_kernels.items():
        require(not cuda or all(
            sum(by_b.get(kn, 0) for by_b in per_index[name].values()) > 0
            for kn in kernels), f"sharded {name} launched {per_index[name]}")
    require(launches["bin_max_round"] == 0
            and launches["bin_max2_raw_fold_pass"] == 0,
            f"the sharded path launched kernels 5 or 8: {launches}")

    # --- each index against its plain passes and the single-device one ---
    held = {}
    for B in SERVE_BATCHES:
        q = q_all[:B]
        exact_scores = bt.plain_scores(q.to(torch.bfloat16),
                                       emb.to(torch.bfloat16))
        fp32_top = torch.topk(bt.plain_scores(q, emb), k, dim=1).indices + 1
        got = answers["exact"][B]
        with plain_exact():
            want = sharded["exact"].topk_from_embeddings(q)
        answers_ok(*got, k, n)
        e_plain = compare_ranked(got[0], got[1] - 1, want[0], want[1] - 1,
                                 exact_scores, gap=TOL)
        one = single["exact"].topk_from_embeddings(q)
        e_single = compare_ranked(got[0], got[1] - 1, one[0], one[1] - 1,
                                  exact_scores, gap=TOL)
        held[f"exact_B{B}"] = {"vs_plain": e_plain, "vs_single": e_single}
        del exact_scores
        for name, rounds in (("quantized", False), ("rounds", True)):
            got, st = hold_sharded_quantized(sharded[name], q, rounds)
            answers_ok(*got, k, n)
            one = single[name].topk_from_embeddings(q)
            st["recall_vs_fp32"] = recall_vs(got[1], fp32_top)
            st["single_recall_vs_fp32"] = recall_vs(one[1], fp32_top)
            require(st["recall_vs_fp32"] >= st["single_recall_vs_fp32"] - 0.005,
                    f"sharded {name} at B={B} loses recall: {st}")
            held[f"{name}_B{B}"] = st
        del fp32_top
    pad_rows = check_pad_rows(sharded["exact"], q_all[:128], dev)
    scores = bt.plain_scores(q_all[:PAD_B].to(torch.bfloat16),
                             emb.to(torch.bfloat16))
    wide = sharded["exact"].topk_from_embeddings(q_all[:PAD_B])
    answers_ok(*padded, k, n)
    held["mesh_2x2_B37"] = compare_ranked(padded[0], padded[1] - 1, wide[0],
                                          wide[1] - 1, scores, gap=TOL)

    # --- the service: the sharded catalog against the single-device one ----
    svc = RetrievalService.load(schema_dir, settings.model_dirpath,
                                settings.index_dirpath, device=dev)
    require(isinstance(svc_d.index, DistributedBruteForceIndex)
            and svc_d.index._engine == "pallas",
            "the sharded service does not run the kernels")
    feat = svc.schema.candidate_id_feature
    want_s = svc.retrieve(raw)
    q_s = svc.embed(svc.encode_query(raw))
    scores = bt.plain_scores(q_s.to(torch.bfloat16), emb.to(torch.bfloat16))
    got_i = torch.from_numpy(feat.encode(np.array(served)).reshape(
        len(served), k)).to(dev)
    want_i = torch.from_numpy(feat.encode(np.array(want_s)).reshape(
        len(want_s), k)).to(dev)
    require(bool((got_i > 0).all()) and all(len(set(r)) == k for r in served),
            "the sharded service answered an unknown or repeated article")
    diff = got_i != want_i
    rows = diff.nonzero()[:, 0]
    s_got = scores[rows, (got_i[diff] - 1).long()]
    s_want = scores[rows, (want_i[diff] - 1).long()]
    require(bool(((s_got - s_want).abs()
                  <= TOL * s_want.abs().clamp_min(1.0)).all()),
            "the sharded service's strings differ between separated scores")
    held["service"] = {"B": len(served), "id_mismatches": int(diff.sum())}

    # --- evaluation_runner: recall counts equal up to ties ----------------
    loaded = load_distributed_index(sharded_dir, mesh)
    files = sorted(p.name for p in Path(sharded_dir).glob("index_shard_*"))
    require(len(files) == SHARDS and loaded.num_candidates == n,
            f"the sharded artifact holds {files}")
    differing = {kk: 0 for kk in mc.ks}
    hits = {"single": [0] * len(mc.ks), "sharded": [0] * len(mc.ks)}
    for b in test_ds.iter_batches(tc.test_batch_size):
        tb = to_device(b, dev)
        with torch.no_grad():
            q = model.query_forward(tb)
        pair = {"single": exact1.topk_from_embeddings(q)[1],
                "sharded": loaded.topk_from_embeddings(q)[1]}
        for side, got_ids in pair.items():
            metric = IndexRecall(mc.ks)
            metric.update(got_ids, tb["article_id"])
            hits[side] = [a + int(h) for a, h in
                          zip(hits[side], metric.hits.tolist())]
        for kk in mc.ks:
            a = pair["single"][:, :kk].sort(1).values
            c = pair["sharded"][:, :kk].sort(1).values
            differing[kk] += int((a != c).any(1).sum())
    rows_n = test_ds.num_rows
    for j, kk in enumerate(mc.ks):
        require(abs(hits["sharded"][j] - hits["single"][j]) <= differing[kk],
                f"recall@{kk}: hit counts {hits} differ beyond the "
                f"{differing[kk]} rows whose top {kk} differ")
        require(abs(res_d[kk] * rows_n - hits["sharded"][j]) < 0.5
                and abs(ctx["final"][kk] * rows_n - hits["single"][j]) < 0.5,
                f"recall@{kk}: runner {res_d[kk]}, counted "
                f"{hits['sharded'][j]} of {rows_n}")

    # --- times: each sharded index beside its single-device one -----------
    times = {}
    for name in sharded:
        for B in SERVE_BATCHES:
            q = q_all[:B]
            times[f"{name}_B{B}"] = {
                side: timed_ms(lambda ix=ix: ix.topk_from_embeddings(q),
                               repeats, dev)
                for side, ix in (("single", single[name]),
                                 ("sharded", sharded[name]))}
    ctx["sharded_ms"] = times
    emit({"sharded": {
        "catalog": n, "E": E, "k": k, "shards": SHARDS,
        "mesh": mesh.shape, "rows_per_shard": sharded["exact"]._emb.per,
        "build_s": build_s, "launches": launches, "per_index": per_index,
        "held": held, "pad_rows": pad_rows, "eval_runner": res_d,
        "eval_runner_single": ctx["final"], "differing_rows": differing,
        "ms": times, "timing": "cuda events, mean of repeats" if cuda
        else "wall"}})
    return launches


# --- phase 13: training over a one-process mesh ------------------------------
MESH_STEPS = 5  # steps each pair holds against the single-device step
MESH_WARMUP, MESH_TIMED = 3, 20  # untimed, then timed steps a mesh path
MESH_SHARDED = ["customer_id", "article_id"]
# (mesh path, its single-device counterpart in TRAIN_PATHS, (data, model),
# row-sharded features), grouped by counterpart
MESH_PATHS = (
    ("dp_dense_adagrad", "dense_adagrad", (4, 1), []),
    ("row_sharded_dense_adagrad_2x2", "dense_adagrad", (2, 2), MESH_SHARDED),
    ("dp_dense_adam", "dense_adam", (4, 1), []),
    ("dp_mixed_negatives", "mixed_negatives", (4, 1), []),
    ("dp_sparse_adagrad", "sparse_adagrad", (4, 1), []),
    ("row_sharded_sparse_2x2", "sparse_adagrad", (2, 2), MESH_SHARDED),
    ("row_sharded_sparse_1x4", "sparse_adagrad", (1, 4), MESH_SHARDED),
)
MESH_RUNNER_SHAPE = (2, 2)


def leaf_tensors(x):
    """The tensors of a state's value: a ``ShardedTable``'s shards, else
    the tensor itself."""
    return list(x.shards) if hasattr(x, "shards") else [x]


def state_values(state):
    """Every value of a single-device or mesh training state by a name:
    tensors, and ``ShardedTable``s of the row-sharded tables and their
    optimizer state."""
    out = {f"params/{n}": p for n, p in state.params.items()}
    opt = getattr(state, "opt_state", None) or state.dense_opt_state
    for field_name, value in opt._asdict().items():
        if isinstance(value, torch.Tensor):
            out[f"opt/{field_name}"] = value
        else:
            out.update({f"opt/{field_name}/{n}": t for n, t in value.items()})
    if hasattr(state, "sparse_state"):
        out.update({f"acc/{n}": t
                    for n, t in state.sparse_state.accumulators.items()})
    return out


def state_tensors(state, rows=None, on=None):
    """Every tensor of a training state by a name (``state_values``): a
    row-sharded value joined and cut to ``rows``, the unpadded row counts by
    parameter name; each on ``on`` (default: its first shard's device)."""
    rows = rows or {}
    out = {}
    for key, value in state_values(state).items():
        parts = [p.detach() for p in leaf_tensors(value)]
        dev = on or parts[0].device
        t = (parts[0].to(dev) if len(parts) == 1
             else torch.cat([p.to(dev) for p in parts]))
        n = rows.get(key.rsplit("/", 1)[-1])
        out[key] = t[:n] if n is not None else t
    return out


def all_tensors(state):
    return [t for v in state_values(state).values() for t in leaf_tensors(v)]


def snapshot(state):
    """A copy of every tensor of ``state``, in the order ``restore`` reads
    it back."""
    return [t.detach().clone() for t in all_tensors(state)]


@torch.no_grad()
def restore(state, saved, step):
    for t, s in zip(all_tensors(state), saved):
        t.copy_(s)
    return state._replace(step=step)


@torch.no_grad()
def load_values(state, want, step):
    """Copy a single-device state's tensors (``state_tensors``' names)
    into ``state``; a row-sharded value shard by shard, its pad rows left
    as they are."""
    for key, value in state_values(state).items():
        src = want[key]
        if not hasattr(value, "shards"):
            value.detach().copy_(src)
            continue
        r = value.rows_per_shard
        for s, shard in enumerate(value.shards):
            lo, hi = s * r, min((s + 1) * r, src.shape[0])
            if lo < hi:
                shard[: hi - lo].copy_(src[lo:hi])
    return state._replace(step=step)


def sync_all():
    """Wait for every visible card."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


class CrossDeviceBytes:
    """Inside the block, the copies from one device to another and their
    bytes, autograd's backward copies included (a ``TorchDispatchMode``
    over ``_to_copy`` and ``copy_``)."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if func is torch.ops.aten._to_copy.default:
                    src, dst = args[0], out
                elif func is torch.ops.aten.copy_.default:
                    dst, src = args[0], args[1]
                else:
                    return out
                if src.device != dst.device:
                    counter.copies += 1
                    counter.bytes += dst.numel() * dst.element_size()
                return out

        self.copies = self.bytes = 0
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        return False


def check_placement(path, state, mesh):
    """Every tensor of a mesh state where the mesh's device map puts it:
    a row shard, and its optimizer state, on ``mesh.model_device(s)``, the
    rest on ``mesh.first_device``; in a process group, exactly the shards
    of this rank's columns (``None`` for another rank's). Returns each
    row-sharded value's shard devices."""
    shards = {}
    for key, value in state_values(state).items():
        if hasattr(value, "shards"):
            got = [None if t is None else str(t.device) for t in value.shards]
            want = [str(mesh.model_device(s)) if mesh.column(s) else None
                    for s in range(len(got))]
            require(got == want, f"{path}: {key}'s shards lie on {got}, "
                    f"their cells are {want}")
            shards[key] = got
        else:
            require(value.device == mesh.first_device,
                    f"{path}: {key} lies on {value.device}, not the first "
                    f"device {mesh.first_device}")
    return {"first_device": str(mesh.first_device),
            "row_shards": shards}


def same_device_replay(path, shape, tc, catalog, negatives, batches, saved,
                       want, n_customers, n_articles, logq, dev):
    """The same path on ``dev`` repeated over the same shape, replayed from
    the distinct devices' initial state over the same batches: whether its
    final bits equal ``want``'s (the distinct devices' replay)."""
    from hm_retrieval_tpu_torch.models.train_path import make_mesh_trainer
    from hm_retrieval_tpu_torch.parallel import make_mesh

    mesh = make_mesh(*shape, devices=[dev] * (shape[0] * shape[1]))
    model = train_model(n_customers, n_articles, logq, False, dev)
    state, step = make_mesh_trainer(model, tc, mesh, catalog)
    state = restore(state, [t.to(dev) for t in saved], 0)
    for i, b in enumerate(batches):
        kw = {"negatives": negatives[i]} if negatives else {}
        state, _ = step(state, b, **kw)
    got = snapshot(state)
    differ = [i for i, (g, w) in enumerate(zip(got, want))
              if not torch.equal(g, w.to(dev))]
    worst = max((float((got[i].float() - want[i].to(dev).float()).abs()
                       .max()) for i in differ if got[i].numel()),
                default=0.0)
    del model, state, step, got
    return {"bits_equal": not differ, "tensors": len(want),
            "tensors_differing": len(differ), "max_abs_err": worst}


def step_under(step, state, batch, kw, sync_check):
    """One step; under ``set_sync_debug_mode("error")`` when
    ``sync_check``: a step that reads a value back to the host raises."""
    if not sync_check:
        return step(state, batch, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return step(state, batch, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def hold_close(name, got, want, rtol, atol):
    """Every tensor of ``want`` in ``got`` within rtol / atol; the worst
    absolute error and its tensor."""
    require(set(got) == set(want), f"{name}: state layouts differ: "
            f"{sorted(set(got) ^ set(want))}")
    worst, worst_name = 0.0, None
    for key, w in want.items():
        g = got[key]
        if not w.is_floating_point():
            require(torch.equal(g, w), f"{name}: {key} differs")
            continue
        require(not g.isnan().any(), f"{name}: NaN in {key}")
        err = (g - w).abs()
        require(bool((err <= atol + rtol * w.abs()).all()),
                f"{name}: {key} outside tolerance, max err "
                f"{float(err.max())}")
        if err.numel() and float(err.max()) > worst:
            worst, worst_name = float(err.max()), key
    return worst, worst_name


def max_err(got, want):
    return max(float((g.float() - want[k].float()).abs().max())
               for k, g in got.items() if g.numel())


def check_lookups(table, mesh, ids):
    """``make_sharded_lookup``'s two strategies over a row-sharded table on
    the card against ``table[ids]`` bit for bit; an overflowing capacity
    poisons with NaN."""
    from hm_retrieval_tpu_torch.parallel import make_sharded_lookup

    want = torch.cat([t.to(ids.device) for t in table.shards])[ids.long()]
    out = {}
    for strategy in ("psum", "all_to_all"):
        got = make_sharded_lookup(mesh, strategy)(table, ids)
        require(torch.equal(got, want), f"{strategy} lookup != table[ids]")
        out[strategy] = "bitwise"
    # a capacity of one distinct id an owner, against hundreds
    over = make_sharded_lookup(mesh, "all_to_all", capacity=1)(table, ids)
    require(bool(over.isnan().all()), "capacity overflow did not give NaN")
    out["overflow_nan"] = True
    return out


def time_mesh_path(step, state, host_batches, mesh, negatives_of):
    """``MESH_WARMUP`` untimed and ``MESH_TIMED`` timed steps through
    ``device_feed(mesh=mesh)``, CUDA events each; then 3 steps under the
    profiler."""
    from hm_retrieval_tpu_torch.data import device_feed

    starts, ends, on_card = [], [], []
    for i, b in enumerate(device_feed(iter(host_batches), mesh=mesh)):
        kw = negatives_of(state.step)
        if i >= MESH_WARMUP:
            starts.append(torch.cuda.Event(enable_timing=True))
            ends.append(torch.cuda.Event(enable_timing=True))
            starts[-1].record()
        state, _ = step(state, b, **kw)
        if i >= MESH_WARMUP:
            ends[-1].record()
        if len(on_card) < 3:
            on_card.append(b)
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in zip(starts, ends)]
    kw = negatives_of(state.step)
    state, prof = profile_steps(lambda s, b: step(s, b, **kw), state, on_card)
    return state, ms, prof


def phase_mesh_training(seed, dev, n_customers=N_CUSTOMERS,
                        n_articles=N_ARTICLES, paths=MESH_PATHS, cells=None,
                        timed=None, replays=None, tag="mesh_training",
                        same_device_bits=False):
    """Phase 13 (a) and (b) (see the module docstring), and phase 17 (a)
    with ``cells``: ``cells(shape)`` lists a path's mesh devices (default
    ``dev`` repeated); ``timed`` runs (b) (default on the card);
    ``replays`` maps a path to its replay steps (default MESH_STEPS);
    ``same_device_bits`` also replays each path on ``dev`` repeated and
    reports whether its bits equal the distinct devices'. Returns a row per
    mesh path."""
    from hm_retrieval_tpu_torch.models import make_single_device_trainer
    from hm_retrieval_tpu_torch.models.mixed_negatives import (
        CandidateCatalog, step_seed,
    )
    from hm_retrieval_tpu_torch.models.train_path import make_mesh_trainer
    from hm_retrieval_tpu_torch.parallel import make_mesh

    cuda = dev.type == "cuda"
    timed = cuda if timed is None else timed
    cells = cells or (lambda shape: [dev] * (shape[0] * shape[1]))
    replays = replays or {}
    rng = np.random.default_rng(seed + 13)
    probs, logq = article_popularity(n_articles)
    n_batches = MESH_STEPS + (MESH_WARMUP + MESH_TIMED if timed else 0)
    rows, catalog_cols = train_columns(rng, n_batches * TRAIN_B, n_customers,
                                       n_articles, probs)
    rows.pop("purchase_history")
    host = [{k: v[i * TRAIN_B:(i + 1) * TRAIN_B] for k, v in rows.items()}
            for i in range(n_batches)]
    batches = [to_device(b, dev) for b in host[:MESH_STEPS]]
    fields = {name: f for name, f, _ in TRAIN_PATHS}
    out, lookups, single = [], None, {}
    for path, single_name, shape, sharded in paths:
        tc = training_config(fields[single_name], check=True)
        if single.get("name") != single_name:
            # the counterpart: its state at the start of each step, from one
            # free-running chain over the same batches (and negatives)
            single.clear()
            if cuda:
                torch.cuda.empty_cache()
            catalog = (CandidateCatalog(catalog_cols, device=dev)
                       if tc.num_uniform_negatives else None)
            negatives = []
            if catalog is not None:  # each step's rows, given to both
                gen = torch.Generator(device=dev)
                for i in range(MESH_STEPS):
                    gen.manual_seed(step_seed(tc.seed, i))
                    negatives.append(
                        catalog.sample(gen, tc.num_uniform_negatives))
            model = train_model(n_customers, n_articles, logq, False, dev)
            state, step = make_single_device_trainer(model, tc, catalog)
            rows_of = {n: p.shape[0] for n, p in state.params.items()}
            chain = [{k: v.clone() for k, v in
                      state_tensors(state, rows_of).items()}]
            losses = []
            for i, b in enumerate(batches):
                kw = {"negatives": negatives[i]} if negatives else {}
                state, m = step(state, b, **kw)
                losses.append(m["loss"])
                chain.append({k: v.clone() for k, v in
                              state_tensors(state, rows_of).items()})
            single = {"name": single_name, "catalog": catalog,
                      "negatives": negatives, "rows": rows_of,
                      "chain": chain, "losses": torch.stack(losses)}
            del model, state, step
        catalog, negatives = single["catalog"], single["negatives"]
        rows_of, chain = single["rows"], single["chain"]
        n_replay = replays.get(path, MESH_STEPS)
        touched = {f: np.unique(np.concatenate(
            [b[f].reshape(-1) for b in host[:MESH_STEPS]]
            + [n[f].cpu().numpy() for n in negatives if f in n]))
            for f in host[0]}

        t0 = time.perf_counter()
        devices = [torch.device(d) for d in cells(shape)]
        distinct = len(set(devices)) > 1
        mesh = make_mesh(*shape, devices=devices)
        model = train_model(n_customers, n_articles, logq, False, dev)
        tc_mesh = dataclasses.replace(tc, sharded_embedding_features=sharded)
        state, step = make_mesh_trainer(model, tc_mesh, mesh, catalog)
        sync_all()
        setup_s = time.perf_counter() - t0
        placed = check_placement(path, state, mesh)
        # one seed gives the mesh path the single-device initial state
        got = state_tensors(state, rows_of, on=dev)
        require(all(torch.equal(got[k], v) for k, v in chain[0].items()),
                f"{path}: the initial state differs from the single "
                f"device's")
        saved = snapshot(state)
        full = {k: torch.cat([t.detach().to(dev) for t in leaf_tensors(v)])
                for k, v in state_values(state).items()
                if hasattr(v, "shards")}
        pads0 = {k: t[rows_of[k.rsplit("/", 1)[-1]]:].clone()
                 for k, t in full.items()}
        del full
        if sharded and lookups is None:
            lookups = check_lookups(
                state.params["query_tower.embeddings.customer_id"], mesh,
                batches[0]["customer_id"])
        # --- (a) each step from the single-device chain's state -----------
        worst, worst_name, losses, step_ms = 0.0, None, [], []
        crossed = None
        for i, b in enumerate(batches):
            state = load_values(state, chain[i], i)
            kw = {"negatives": negatives[i]} if negatives else {}
            sync_all()
            t_step = time.perf_counter()
            if distinct and i == 0:  # the bytes one step moves across
                with CrossDeviceBytes() as crossed:
                    state, m = step(state, b, **kw)
            else:
                state, m = step_under(step, state, b, kw,
                                      cuda and not distinct and i == 1)
            sync_all()
            step_ms.append((time.perf_counter() - t_step) * 1e3)
            losses.append(m["loss"])
            got = state_tensors(state, rows_of, on=dev)
            err, err_name = hold_close(f"{path} step {i}", got, chain[i + 1],
                                       TRAIN_RTOL, TRAIN_ATOL)
            if err >= worst:
                worst, worst_name = err, f"step {i}: {err_name}"
        losses = torch.stack([x.to(dev) for x in losses])
        require(bool(torch.isfinite(losses).all()), f"{path}: a loss is NaN")
        require(bool(torch.allclose(losses, single["losses"], rtol=1e-5,
                                    atol=0)),
                f"{path}: losses {losses.tolist()} against the single "
                f"device's {single['losses'].tolist()}")
        # --- replays: free-running steps twice from the initial state -----
        runs = []
        for _ in range(2):
            state = restore(state, saved, 0)
            run_losses = []
            for i, b in enumerate(batches[:n_replay]):
                kw = {"negatives": negatives[i]} if negatives else {}
                state, m = step(state, b, **kw)
                run_losses.append(m["loss"].to(dev))
            runs.append((snapshot(state), torch.stack(run_losses)))
        require(torch.equal(runs[0][1], runs[1][1]),
                f"{path}: replayed losses differ")
        require(all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0])),
                f"{path}: the replays' states differ")
        # the free-running chain against the single-device one: a reading
        # (a ReLU whose input is within rounding of 0 can take another side)
        free = state_tensors(state, rows_of, on=dev)
        free_err = max_err({k: v for k, v in free.items()
                            if k.startswith("params/")}, chain[n_replay])
        # pad rows as they started; rows no step touched bit-unchanged
        init = dict(zip([id(t) for t in all_tensors(state)], saved))
        for k, pad in pads0.items():
            now = torch.cat([t.detach().to(dev) for t in
                             leaf_tensors(state_values(state)[k])])
            require(torch.equal(now[rows_of[k.rsplit("/", 1)[-1]]:], pad),
                    f"{path}: a pad row of {k} changed")
        untouched = 0
        for key, value in state_values(state).items():
            if ".embeddings." not in key or key.startswith("opt/"):
                continue
            feature = key.rsplit(".", 1)[-1]
            for s, t in enumerate(leaf_tensors(value)):
                ids = touched[feature] - s * t.shape[0]
                ids = ids[(ids >= 0) & (ids < t.shape[0])]
                mask = torch.ones(t.shape[0], dtype=torch.bool,
                                  device=t.device)
                mask[torch.from_numpy(ids).to(t.device).long()] = False
                require(torch.equal(t.detach()[mask], init[id(t)][mask]),
                        f"{path}: an untouched row of {key} changed")
                untouched += int(mask.sum())
        row = {"path": path, "single_device": single_name,
               "mesh": {"data": shape[0], "model": shape[1]},
               "devices": [str(d) for d in devices],
               "sharded": sharded, "B": TRAIN_B, "setup_s": setup_s,
               "losses": losses.tolist(),
               "single_losses": single["losses"].tolist(),
               "max_abs_err_per_step": worst, "worst_tensor": worst_name,
               "free_running_params_max_abs_err": free_err,
               "tensors": len(chain[0]), "pad_rows": sum(
                   v.shape[0] for k, v in pads0.items()
                   if k.startswith("params/")),
               "untouched_rows_checked": untouched,
               "replay_bitwise": True, "replay_steps": n_replay,
               "sync_free_step": cuda and not distinct,
               "rtol": TRAIN_RTOL, "atol": TRAIN_ATOL}
        if distinct:
            row.update({
                "placement": placed,
                "cross_device_bytes_per_step": crossed.bytes,
                "cross_device_copies_per_step": crossed.copies,
                "agreement_step_ms": step_ms,
                "median_agreement_step_ms": statistics.median(step_ms[1:])})
        if same_device_bits:
            row["same_device_mesh"] = same_device_replay(
                path, shape, tc_mesh, catalog, negatives, batches[:n_replay],
                saved, runs[0][0], n_customers, n_articles, logq, dev)
        del runs, init, saved
        # --- (b) time ---------------------------------------------------------
        if timed:
            def negatives_of(step_no, catalog=catalog, tc=tc):
                if catalog is None:
                    return {}
                g = torch.Generator(device=dev)
                g.manual_seed(step_seed(tc.seed, step_no))
                return {"negatives": catalog.sample(
                    g, tc.num_uniform_negatives)}

            # the baseline holds the single-device chain and this path's
            # state; the peak adds what the steps allocate
            cards = sorted({d.index for d in devices if d.type == "cuda"})
            for c in cards:
                torch.cuda.reset_peak_memory_stats(c)
            base_gb = torch.cuda.memory_allocated() / 1e9
            state, ms, prof = time_mesh_path(step, state, host[MESH_STEPS:],
                                             mesh, negatives_of)
            median = statistics.median(ms)
            row.update({
                "timed_steps": len(ms), "median_step_ms": median,
                "min_step_ms": min(ms), "max_step_ms": max(ms),
                "examples_per_s": TRAIN_B / median * 1e3, "profile": prof,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "held_before_steps_gb": base_gb})
            if len(cards) > 1:
                row["peak_mem_gb_by_card"] = {
                    c: torch.cuda.max_memory_allocated(c) / 1e9
                    for c in cards}
        emit({tag: row})
        out.append(row)
        del model, state, step, got, free, pads0
        if cuda:
            torch.cuda.empty_cache()
    single.clear()
    emit({tag.replace("training", "lookups"): lookups})
    return out


def phase_mesh_runner(ctx, dev, workdir):
    """Phase 13 (c) (see the module docstring). Returns each kernel's
    launches over the runner over the mesh."""
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt
    from hm_retrieval_tpu_torch.parallel import make_mesh
    from hm_retrieval_tpu_torch.runners import (
        CheckpointManager, evaluation_runner, modelling_runner,
    )
    from hm_retrieval_tpu_torch.schema import Schema
    from hm_retrieval_tpu_torch.utils.pytree_io import load_pytree_npz

    cuda = dev.type == "cuda"
    settings = ctx["settings"]
    schema = Schema.load(settings.schema_dirpath)
    schema.training_config = dataclasses.replace(
        schema.training_config, sharded_embedding_features=MESH_SHARDED)
    schema.save(str(workdir / "mesh_schema"))
    settings = dataclasses.replace(
        settings, schema_dirpath=str(workdir / "mesh_schema"),
        checkpoint_dirpath=str(workdir / "mesh_checkpoints"),
        model_dirpath=str(workdir / "mesh_model"),
        index_dirpath=str(workdir / "mesh_index"),
        tensorboard_logs_dir=None, profile_steps=None)
    D, S = MESH_RUNNER_SHAPE
    mesh = make_mesh(D, S, devices=[dev] * (D * S))
    log = Records(logging.INFO)
    loggers = [logging.getLogger(f"hm_retrieval_tpu_torch.{name}")
               for name in ("runners.modelling", "models.train_path")]
    levels = [lg.level for lg in loggers]
    for lg in loggers:
        lg.setLevel(logging.INFO)
        lg.addHandler(log)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    # --- the main path: the runner over the mesh, counts from 0 ------------
    bt.reset_launches()
    qt.reset_launches()
    t0 = time.perf_counter()
    try:
        results = modelling_runner(settings, mesh=mesh, distributed_index=True,
                                   device=dev)
    finally:
        for lg, level in zip(loggers, levels):
            lg.removeHandler(log)
            lg.setLevel(level)
    runner_s = time.perf_counter() - t0
    launches = kernel_counts()
    # ----------------------------------------------------------------------
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    tc, mc = schema.training_config, schema.model_config
    for name in ("initial", "final"):
        check_runner_recall(name, results[name], mc.ks)
    require(results["final"][100] > results["initial"][100],
            f"recall@100 over the mesh did not rise: {results}")
    require(not cuda or (launches["bin_max2_first_round"] > 0
                         and launches["bin_max2_round"] > 0),
            f"the mesh's evaluate did not launch kernels 1-2: {launches}")
    require(all(v == 0 for k, v in launches.items()
                if k not in ("bin_max2_first_round", "bin_max2_round")),
            f"the runner over the mesh launched other kernels: {launches}")
    throughput = [float(m.split()[2]) for m in log.records
                  if m.startswith("Training throughput")]
    require(len(throughput) == 1, f"throughput lines: {throughput}")
    require(any("row-sharded sparse" in m for m in log.records),
            "the runner did not take the row-sharded sparse step")
    steps = RUNNER_TRAIN_ROWS // tc.train_batch_size
    ckpt = CheckpointManager(settings.checkpoint_dirpath, device=dev)
    require(ckpt.latest_step() == steps,
            f"checkpoint at step {ckpt.latest_step()}, not {steps}")
    # the exported towers: phase 10's unpadded shapes
    for tower in ("query_tower", "candidate_tower"):
        got = load_pytree_npz(f"{settings.model_dirpath}/{tower}/params.npz")
        want = load_pytree_npz(
            f"{ctx['settings'].model_dirpath}/{tower}/params.npz")
        shapes = [(np.shape(a), np.shape(b)) for a, b in zip(
            flatten_tree(got), flatten_tree(want))]
        require(all(a == b for a, b in shapes) and len(shapes) == len(
            flatten_tree(want)), f"exported {tower} shapes {shapes}")

    # --- eval only over the mesh, from the checkpoint ----------------------
    ckpt.close()
    with checkpoint_times() as ckpt_ms:
        t0 = time.perf_counter()
        eval_only = evaluation_runner(
            dataclasses.replace(settings,
                                index_dirpath=str(workdir / "mesh_index_eval")),
            mesh=mesh, distributed_index=True, device=dev)
        eval_runner_s = time.perf_counter() - t0
        require(eval_only == results["final"],
                f"evaluation_runner {eval_only} != final {results['final']}")
        # --- a resumed run continues the step count -------------------------
        resumed = modelling_runner(settings, mesh=mesh, resume=True,
                                   distributed_index=True, device=dev)
    ckpt = CheckpointManager(settings.checkpoint_dirpath, device=dev)
    require(ckpt.latest_step() == 2 * steps,
            f"the resumed run ended at step {ckpt.latest_step()}")
    require(resumed["initial"] == results["final"],
            f"the resumed run began at {resumed['initial']}, not "
            f"{results['final']}")
    require(len(ckpt_ms["restore"]) == 2 and len(ckpt_ms["write"]) == 1,
            f"checkpoint operations: {ckpt_ms}")
    ckpt_bytes = (Path(settings.checkpoint_dirpath) / str(2 * steps)
                  / "state.npz").stat().st_size
    ctx.update(mesh_settings=settings, mesh_initial=results["initial"],
               mesh_final=results["final"], mesh_resumed=resumed["final"])
    emit({"mesh_runner": {
        "mesh": mesh.shape, "sharded": MESH_SHARDED,
        "distributed_index": True, "steps": steps, "runner_s": runner_s,
        "initial": results["initial"], "final": results["final"],
        "single_device_initial": ctx["initial"],
        "single_device_final": ctx["final"],
        "train_examples_per_s": throughput[0], "trace": "off",
        "launches": launches, "eval_runner_s": eval_runner_s,
        "eval_runner_equals_final": True, "checkpoint_bytes": ckpt_bytes,
        "checkpoint_save_copy_ms": ckpt_ms["copy"][0],
        "checkpoint_save_ms": ckpt_ms["copy"][0] + ckpt_ms["write"][0],
        "checkpoint_restore_ms": ckpt_ms["restore"],
        "resumed_final": resumed["final"], "resumed_steps": 2 * steps,
        "peak_mem_gb": peak_gb}})
    return launches


# --- phase 14: several processes on the one card ----------------------------
PROC_RANKS = 2  # ranks of phase 14's gloo group, both on the one card
PROC_TIMEOUT = 480  # seconds the parent waits for both ranks
PROC_STEPS = 3  # steps each path holds against the single-device chain
# timed steps after the held ones, and steps under the profiler on rank 0
PROC_TIMED = {"sparse": 5, "dense": 1}
PROC_PROFILED = {"sparse": 2, "dense": 0}
# (path, its single-device counterpart in TRAIN_PATHS, (data, model),
# row-sharded features)
PROC_PATHS = (
    ("dp_sparse_adagrad", "sparse_adagrad", (4, 1), []),
    ("row_sharded_sparse_1x4", "sparse_adagrad", (1, 4), MESH_SHARDED),
    ("dp_dense_adagrad", "dense_adagrad", (4, 1), []),
)


def sync_card():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def exchanged():
    """Inside the block, the bytes this rank sends through the group's
    exchanges (``exchange_bytes``, ``broadcast_from``) and their wall ms,
    synchronised."""
    from hm_retrieval_tpu_torch.parallel import collectives as co

    rec = {"calls": 0, "bytes": 0, "ms": 0.0}
    fns = {"exchange_bytes": co.exchange_bytes,
           "broadcast_from": co.broadcast_from}

    def sent(name, args):
        if name == "exchange_bytes":
            return sum(t.numel() * t.element_size() for t in args[0])
        shape, dtype = args[1], args[2]
        return int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()

    def timed(name):
        def run(*args, **kwargs):
            sync_card()
            t0 = time.perf_counter()
            out = fns[name](*args, **kwargs)
            sync_card()
            rec["ms"] += (time.perf_counter() - t0) * 1e3
            rec["calls"] += 1
            rec["bytes"] += sent(name, args)
            return out
        return run

    with swapped(co, **{name: timed(name) for name in fns}):
        yield rec


def fingerprint(t, chunk=1 << 24):
    """An exact integer of ``t``'s bits (a weighted sum of its 32-bit
    words, in chunks), equal on two ranks only if their tensors almost
    surely are."""
    words = t.detach().contiguous().reshape(-1).view(torch.int32)
    total = 0
    for lo in range(0, words.numel(), chunk):
        w = words[lo:lo + chunk].long()
        weights = torch.arange(lo, lo + w.numel(), device=w.device) % 1000003
        total += int((w * (weights + 1)).sum())
    return total


def local_pieces(state):
    """Each value of a training state (``state_values``) as this rank's
    (first row, tensor) pieces: a row-sharded value's held shards."""
    out = {}
    for key, value in state_values(state).items():
        if hasattr(value, "shards"):
            r = value.rows_per_shard
            out[key] = [(s * r, t) for s, t in enumerate(value.shards)
                        if t is not None]
        else:
            out[key] = [(0, value)]
    return out


@torch.no_grad()
def load_pieces(state, want, step):
    """Copy a single-device state's tensors into this rank's pieces, pad
    rows left as they are."""
    for key, pieces in local_pieces(state).items():
        src = want[key]
        for lo, t in pieces:
            n = max(0, min(t.shape[0], src.shape[0] - lo))
            t[:n].copy_(src[lo:lo + n])
    return state._replace(step=step)


def hold_pieces(name, state, want):
    """This rank's pieces against a single-device state within rtol / atol;
    the worst absolute error."""
    worst = 0.0
    for key, pieces in local_pieces(state).items():
        for lo, t in pieces:
            n = max(0, min(t.shape[0], want[key].shape[0] - lo))
            w = want[key][lo:lo + n]
            g = t.detach()[:n].to(w.device)
            if not w.is_floating_point():
                require(torch.equal(g, w), f"{name}: {key} differs")
                continue
            err = (g - w).abs()
            require(bool((err <= TRAIN_ATOL + TRAIN_RTOL * w.abs()).all()),
                    f"{name}: {key} outside tolerance, max err "
                    f"{float(err.max())}")
            if err.numel():
                worst = max(worst, float(err.max()))
    return worst


def check_untouched(path, state, saved, initial, batches):
    """Pad rows as they started and table rows no step of ``batches``
    touched bit-unchanged, in this rank's pieces (``local_pieces``) against
    ``saved``, their copies in the same order; ``initial`` gives each
    table's unpadded rows. Returns (untouched rows, pad rows) checked."""
    touched = {f: np.unique(np.concatenate([h[f].reshape(-1)
                                            for h in batches]))
               for f in batches[0]}
    init = dict(zip([id(t) for p in local_pieces(state).values()
                     for _, t in p], saved))
    untouched = pad_rows = 0
    for key, pieces in local_pieces(state).items():
        if ".embeddings." not in key or key.startswith("opt/"):
            continue
        feature = key.rsplit(".", 1)[-1]
        true_rows = initial[key].shape[0]
        for lo, t in pieces:
            ids = touched[feature] - lo
            ids = ids[(ids >= 0) & (ids < t.shape[0])]
            mask = torch.ones(t.shape[0], dtype=torch.bool, device=t.device)
            mask[torch.from_numpy(ids).to(t.device).long()] = False
            require(torch.equal(t.detach()[mask], init[id(t)][mask]),
                    f"{path}: an untouched or pad row of {key} changed")
            untouched += int(mask.sum())
            pad_rows += max(0, lo + t.shape[0] - true_rows)
    return untouched, pad_rows


def replicated_prints(state):
    """Fingerprints of the state's replicated tensors, in a fixed order:
    every rank holds them, and they must agree bit for bit."""
    return [fingerprint(v) for _, v in sorted(state_values(state).items())
            if not hasattr(v, "shards")]


def proc_serve(rank, spec, dev, repeats, workdir):
    """Phase 14 (a) on one rank: the exact and the one-pass sharded index
    over (1, 4), shards 2r and 2r + 1 here."""
    from hm_retrieval_tpu_torch.indices import (
        DistributedBruteForceIndex, DistributedQuantizedIndex,
    )
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt
    from hm_retrieval_tpu_torch.parallel import make_mesh

    with np.load(spec["catalog"]) as z:
        ids, emb = z["identifiers"], z["embeddings"]
    q_all = torch.from_numpy(np.load(spec["queries"])).to(dev)
    P = spec.get("ranks", PROC_RANKS)
    mesh = make_mesh(1, SHARDS, devices=[dev] * (SHARDS // P))
    mine = [SHARDS // P * rank + j for j in range(SHARDS // P)]
    require(mesh.local_cols() == mine and mesh.process_count == P,
            f"rank {rank} holds columns {mesh.local_cols()}")
    indices = {
        "exact": DistributedBruteForceIndex(SERVE_K, ids, emb, mesh=mesh,
                                            method="pallas"),
        "quantized": DistributedQuantizedIndex(SERVE_K, ids, emb, mesh=mesh,
                                               method="pallas"),
    }
    require(all(ix._engine == "pallas" for ix in indices.values()),
            "a sharded index does not run the kernels")
    # --- the main path: counts from 0 --------------------------------------
    bt.reset_launches()
    qt.reset_launches()
    answers = {}
    with exchanged() as ex:
        for name, ix in indices.items():
            for B in SERVE_BATCHES:
                v, i = ix.topk_from_embeddings(q_all[:B])
                answers[f"{name}_B{B}_scores"] = v.cpu().numpy()
                answers[f"{name}_B{B}_ids"] = i.cpu().numpy()
    sync(dev)
    launches = kernel_counts()
    # ----------------------------------------------------------------------
    np.savez(workdir / f"answers{rank}.npz", **answers)
    times = {}
    for name, ix in indices.items():
        for B in SERVE_BATCHES:
            q = q_all[:B]
            ms = timed_ms(lambda ix=ix, q=q: ix.topk_from_embeddings(q),
                          repeats, dev)
            with exchanged() as one:
                ix.topk_from_embeddings(q)
            times[f"{name}_B{B}"] = {"ms": ms, "exchange_bytes": one["bytes"],
                                     "exchange_ms": one["ms"]}
    return {"mesh": [1, SHARDS], "columns": mine, "launches": launches,
            "exchange": ex, "ms": times}


def proc_eval(rank, spec, dev, workdir):
    """Phase 14 (b) on one rank: ``evaluation_runner`` over (2, 2), data
    row r here, with and without the sharded index; ``to_local``."""
    import hashlib

    from hm_retrieval_tpu_torch.indices import DistributedBruteForceIndex
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt
    from hm_retrieval_tpu_torch.parallel import make_mesh
    from hm_retrieval_tpu_torch.runners import evaluation_runner
    from hm_retrieval_tpu_torch.utils.settings import Settings

    settings = Settings.from_json(spec["settings"])
    mesh = make_mesh(2, 2, devices=[dev] * 2)
    require(mesh.local_rows() == [rank], f"rank {rank}: rows "
            f"{mesh.local_rows()}")
    plain_dir, dist_dir = workdir / "proc_index", workdir / "proc_index_dist"
    # --- the main path: counts from 0 --------------------------------------
    bt.reset_launches()
    qt.reset_launches()
    with exchanged() as ex:
        t0 = time.perf_counter()
        plain = evaluation_runner(
            dataclasses.replace(settings, index_dirpath=str(plain_dir)),
            mesh=mesh, device=dev)
        t1 = time.perf_counter()
        sharded = evaluation_runner(
            dataclasses.replace(settings, index_dirpath=str(dist_dir)),
            mesh=mesh, distributed_index=True, device=dev)
        t2 = time.perf_counter()
    launches = kernel_counts()
    # ----------------------------------------------------------------------
    index = DistributedBruteForceIndex.load(str(dist_dir), mesh=mesh)
    with exchanged() as to_local_ex:
        flat = index.to_local()
    n = flat.num_candidates
    digest = hashlib.sha256(
        flat.embeddings[:n].cpu().numpy().tobytes()
        + flat.identifiers[:n].cpu().numpy().tobytes()).hexdigest()
    files = sorted(p.name for p in dist_dir.glob("index_shard_*.npz"))
    return {"mesh": [2, 2], "row": rank,
            "recall": {str(k): v for k, v in plain.items()},
            "recall_sharded": {str(k): v for k, v in sharded.items()},
            "runner_s": t1 - t0, "runner_sharded_s": t2 - t1,
            "launches": launches, "exchange": ex, "to_local_digest": digest,
            "to_local_exchange": to_local_ex, "shard_files": files}


def proc_train_path(rank, path, single_name, shape, sharded, host, logq,
                    dev, sizes, ranks=PROC_RANKS):
    """Phase 14 (c) for one path on one rank (see ``proc_train``)."""
    from hm_retrieval_tpu_torch.data import device_feed
    from hm_retrieval_tpu_torch.models import make_single_device_trainer
    from hm_retrieval_tpu_torch.models.train_path import make_mesh_trainer
    from hm_retrieval_tpu_torch.parallel import make_mesh

    kind = "sparse" if "sparse" in path else "dense"
    fields = {name: f for name, f, _ in TRAIN_PATHS}
    tc = training_config(fields[single_name], check=True)
    batches = [to_device(b, dev) for b in host[:PROC_STEPS]]
    # the single-device chain: its state at each step (the same bits on
    # both ranks: one card, one program)
    model = train_model(*sizes, logq, False, dev)
    state, step = make_single_device_trainer(model, tc)
    rows_of = {n: p.shape[0] for n, p in state.params.items()}
    chain = [{k: v.clone() for k, v in state_tensors(state, rows_of).items()}]
    single_losses = []
    for b in batches:
        state, m = step(state, b)
        single_losses.append(m["loss"])
        chain.append({k: v.clone() for k, v in
                      state_tensors(state, rows_of).items()})
    single_losses = torch.stack(single_losses)
    del model, state, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    D, S = shape
    mesh = make_mesh(D, S, devices=[dev] * (D * S // ranks))
    rows = mesh.local_rows()
    b = TRAIN_B // D

    def local(batch):
        """This rank's rows of a global batch: its data rows'."""
        return {k: v[rows[0] * b:(rows[-1] + 1) * b] for k, v in
                batch.items()}

    model = train_model(*sizes, logq, False, dev)
    state, step = make_mesh_trainer(
        model, dataclasses.replace(tc, sharded_embedding_features=sharded),
        mesh)
    sync(dev)
    held0 = hold_pieces(f"{path} initial", state, chain[0])
    require(held0 == 0.0, f"{path}: the initial state differs from the "
            "single device's")
    saved = [t.detach().clone() for p in local_pieces(state).values()
             for _, t in p]
    # --- (c) each step from the single-device chain's state ---------------
    worst, losses, prints = 0.0, [], []
    bytes_a_step = []
    for i, batch in enumerate(batches):
        state = load_pieces(state, chain[i], i)
        with exchanged() as ex:
            state, m = step(state, local(batch))
            sync(dev)
        bytes_a_step.append(ex["bytes"])
        losses.append(m["loss"])
        worst = max(worst, hold_pieces(f"{path} step {i}", state,
                                       chain[i + 1]))
        prints.append(replicated_prints(state))
    losses = torch.stack(losses)
    require(bool(torch.isfinite(losses).all()), f"{path}: a loss is NaN")
    require(bool(torch.allclose(losses, single_losses, rtol=1e-6, atol=0)),
            f"{path}: losses {losses.tolist()} against the single device's "
            f"{single_losses.tolist()}")
    # --- replays from the initial state, bit-identical --------------------
    replay_steps = PROC_STEPS if kind == "sparse" else 1
    runs = []
    for _ in range(2):
        with torch.no_grad():
            for t, s0 in zip([t for p in local_pieces(state).values()
                              for _, t in p], saved):
                t.copy_(s0)
        state = state._replace(step=0)
        run_losses = []
        for batch in batches[:replay_steps]:
            state, m = step(state, local(batch))
            run_losses.append(m["loss"])
        runs.append(([t.detach().clone() for p in
                      local_pieces(state).values() for _, t in p],
                     torch.stack(run_losses)))
    require(torch.equal(runs[0][1], runs[1][1]),
            f"{path}: replayed losses differ")
    require(all(torch.equal(x, y) for x, y in zip(runs[0][0], runs[1][0])),
            f"{path}: the replays' states differ")
    untouched, pad_rows = check_untouched(path, state, saved, chain[0],
                                          host[:replay_steps])
    del runs, saved
    # --- time: steps through device_feed, CUDA events on the card ---------
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    timed = PROC_TIMED[kind]
    marks = []
    feed = [local(h) for h in host[PROC_STEPS:PROC_STEPS + timed]]
    with exchanged() as ex_t:
        for fb in device_feed(iter(feed), mesh=mesh):
            marks.append([torch.cuda.Event(enable_timing=True)
                          for _ in range(2)] if cuda else [time.perf_counter()])
            if cuda:
                marks[-1][0].record()
            state, _ = step(state, fb)
            if cuda:
                marks[-1][1].record()
            else:
                marks[-1].append(time.perf_counter())
    sync(dev)
    ms = [x.elapsed_time(y) if cuda else (y - x) * 1e3 for x, y in marks]
    on_card = [to_device(local(h), dev) for h in
               host[PROC_STEPS + timed:PROC_STEPS + timed
                    + PROC_PROFILED[kind]]]
    if rank == 0 and cuda and on_card:
        state, prof = profile_steps(step, state, on_card)
    else:  # the same steps, so the collectives pair up
        for fb in on_card:
            state, _ = step(state, fb)
        prof = None
    sync(dev)
    return {
        "path": path, "single_device": single_name,
        "mesh": {"data": D, "model": S}, "rows": rows,
        "columns": mesh.local_cols(), "sharded": sharded,
        "local_B": b * len(rows), "global_B": TRAIN_B,
        "losses": losses.tolist(), "single_losses": single_losses.tolist(),
        "max_abs_err_per_step": worst, "rtol": TRAIN_RTOL,
        "atol": TRAIN_ATOL, "replicated_prints": prints,
        "replay_bitwise": True, "replay_steps": replay_steps,
        "untouched_rows_checked": untouched, "pad_rows": pad_rows,
        "bytes_sent_per_step": bytes_a_step, "timed_steps": len(ms),
        "median_step_ms": statistics.median(ms), "step_ms": ms,
        "exchange_ms_per_step": ex_t["ms"] / max(1, len(ms)),
        "profile": prof,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda
        else None,
    }


def proc_train(rank, seed, dev, sizes, ranks=PROC_RANKS):
    """Phase 14 (c) on one rank: phase 13's stream and model, each path's
    mesh split over the ranks (data-parallel: this rank's data rows fed its
    rows; row-sharded (1, 4): both ranks fed the whole batch)."""
    rng = np.random.default_rng(seed + 13)
    probs, logq = article_popularity(sizes[1])
    n_batches = PROC_STEPS + max(PROC_TIMED.values()) + max(
        PROC_PROFILED.values())
    cols, _ = train_columns(rng, n_batches * TRAIN_B, *sizes, probs)
    cols.pop("purchase_history")
    host = [{k: v[i * TRAIN_B:(i + 1) * TRAIN_B] for k, v in cols.items()}
            for i in range(n_batches)]
    out = []
    for path, single_name, shape, sharded in PROC_PATHS:
        row = proc_train_path(rank, path, single_name, shape, sharded, host,
                              logq, dev, sizes, ranks)
        emit({"process_training": {"rank": rank, **{
            k: v for k, v in row.items() if k != "replicated_prints"}}})
        out.append(row)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def proc_runner(rank, spec, dev, workdir):
    """Phase 14 (d) on one rank: phase 13's one-process checkpoint restored
    by the group, then ``modelling_runner`` over (2, 2), both id tables
    row-sharded, the sharded index."""
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt
    from hm_retrieval_tpu_torch.parallel import make_mesh
    from hm_retrieval_tpu_torch.runners import (
        evaluation_runner, modelling_runner,
    )
    from hm_retrieval_tpu_torch.utils.settings import Settings

    settings = Settings.from_json(spec["mesh_settings"])
    mesh = make_mesh(2, 2, devices=[dev] * 2)
    # --- the main path: counts from 0 --------------------------------------
    bt.reset_launches()
    qt.reset_launches()
    with exchanged() as ex:
        t0 = time.perf_counter()
        reverse = evaluation_runner(
            dataclasses.replace(settings,
                                index_dirpath=str(workdir / "proc_rev")),
            mesh=mesh, distributed_index=True, device=dev)
        t1 = time.perf_counter()
        res = modelling_runner(proc_runner_settings(settings, workdir),
                               mesh=mesh, distributed_index=True, device=dev)
        t2 = time.perf_counter()
    launches = kernel_counts()
    # ----------------------------------------------------------------------
    return {"mesh": [2, 2], "reverse_recall": {str(k): v for k, v in
                                               reverse.items()},
            "initial": {str(k): v for k, v in res["initial"].items()},
            "final": {str(k): v for k, v in res["final"].items()},
            "eval_runner_s": t1 - t0, "runner_s": t2 - t1,
            "launches": launches, "exchange": ex}


def proc_runner_settings(settings, workdir):
    """Where phase 14's group runner writes."""
    return dataclasses.replace(
        settings, checkpoint_dirpath=str(workdir / "proc_ckpt"),
        model_dirpath=str(workdir / "proc_model"),
        index_dirpath=str(workdir / "proc_runner_index"))


def process_rank(rank, workdir, seed, repeats):
    """Phase 14's rank ``rank``: joins the gloo group on the one card, runs
    (a)-(c) and writes its results to ``workdir/rank{rank}.json``."""
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist

    from hm_retrieval_tpu_torch.parallel.mesh import initialize_multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    workdir = Path(workdir)
    spec = json.loads((workdir / "spec.json").read_text())
    # phase 14: two gloo ranks sharing the card; phase 18's four-card
    # branch: a card a rank over NCCL
    P, backend = spec.get("ranks", PROC_RANKS), spec.get("backend", "gloo")
    want = (torch.device("cuda", rank) if backend == "nccl"
            else torch.device(spec["device"]))
    dev = initialize_multihost(f"file://{workdir / 'rdzv'}", P, rank,
                               device=None if want.type == "cuda" else want)
    require(dev == want and dist.get_backend() == backend,
            f"rank {rank} on {dev} over {dist.get_backend()}")
    parts = spec.get("parts", ["serve", "eval", "train", "runner"])
    t0 = time.perf_counter()
    out = {"rank": rank, "device": str(dev), "backend": dist.get_backend(),
           "world": dist.get_world_size()}
    if "serve" in parts:
        out["serve"] = proc_serve(rank, spec, dev, repeats, workdir)
    if "eval" in parts:
        out["eval"] = proc_eval(rank, spec, dev, workdir)
    if "train" in parts:
        out["train"] = proc_train(rank, seed, dev, spec["sizes"], P)
    if "runner" in parts:
        out["runner"] = proc_runner(rank, spec, dev, workdir)
    out["seconds"] = time.perf_counter() - t0
    out["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                          if dev.type == "cuda" else None)
    out["foreign_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "hm_retrieval_tpu"))
    emit({"process_rank": {k: out[k] for k in (
        "rank", "device", "backend", "world", "seconds", "peak_mem_gb",
        "foreign_modules")}, **{k: out[k] for k in ("serve", "eval", "runner")
                                if k in out}})
    (workdir / f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()


def spawn_ranks(fn, args, nprocs, timeout, what):
    """``fn(rank, *args)`` on ``nprocs`` spawned ranks; a rank that fails,
    or the group running past ``timeout``, fails the phase, every rank
    killed first."""
    import torch.multiprocessing as mp

    procs = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                               start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not procs.join(timeout=5):
            require(time.monotonic() < deadline,
                    f"{what}'s ranks ran past {timeout} s")
    finally:
        for proc in procs.processes:
            if proc.is_alive():
                proc.kill()
        for proc in procs.processes:
            proc.join(10)


def phase_processes(ctx, seed, repeats, dev, workdir, mesh_rows,
                    n_customers=N_CUSTOMERS, n_articles=N_ARTICLES):
    """Phase 14 (see the module docstring). Returns each kernel's launches
    over both ranks' main paths. On the CPU it rehearses small (phase 10's
    rehearsal sizes for ``ctx``, ``n_customers`` / ``n_articles`` for (c))."""
    from hm_retrieval_tpu_torch.indices import (
        DistributedBruteForceIndex, DistributedQuantizedIndex,
        load_distributed_index,
    )
    from hm_retrieval_tpu_torch.parallel import make_mesh
    from hm_retrieval_tpu_torch.runners import (
        evaluation_runner, modelling_runner,
    )

    settings, exact1, model = ctx["settings"], ctx["index"], ctx["model"]
    tc = ctx["tc"]
    n = exact1.num_candidates
    ids = exact1.identifiers[:n].cpu().numpy()
    emb = exact1.embeddings[:n]
    first = to_device(next(ctx["test_ds"].iter_batches(tc.test_batch_size)),
                      dev)
    with torch.no_grad():
        q_all = model.query_forward(first)[: max(SERVE_BATCHES)]
    np.savez(workdir / "catalog.npz", identifiers=ids,
             embeddings=emb.cpu().numpy())
    np.save(workdir / "queries.npy", q_all.cpu().numpy())
    settings.to_json(str(workdir / "settings.json"))
    ctx["mesh_settings"].to_json(str(workdir / "mesh_settings.json"))
    # the references: phase 12's one-process S = 4 indices on the same
    # queries, and evaluation_runner over a one-process (2, 2) mesh
    mesh = make_mesh(1, SHARDS, devices=[dev] * SHARDS)
    ref = {}
    for name, ix in (
        ("exact", DistributedBruteForceIndex(SERVE_K, ids, emb, mesh=mesh,
                                             method="pallas")),
        ("quantized", DistributedQuantizedIndex(SERVE_K, ids, emb,
                                                mesh=mesh, method="pallas")),
    ):
        for B in SERVE_BATCHES:
            v, i = ix.topk_from_embeddings(q_all[:B])
            ref[f"{name}_B{B}_scores"] = v.cpu().numpy()
            ref[f"{name}_B{B}_ids"] = i.cpu().numpy()
    ref_sharded = evaluation_runner(
        dataclasses.replace(settings,
                            index_dirpath=str(workdir / "ref_index_22")),
        mesh=make_mesh(2, 2, devices=[dev] * 4), distributed_index=True,
        device=dev)
    del mesh
    (workdir / "spec.json").write_text(json.dumps({
        "catalog": str(workdir / "catalog.npz"),
        "queries": str(workdir / "queries.npy"),
        "settings": str(workdir / "settings.json"),
        "mesh_settings": str(workdir / "mesh_settings.json"),
        "device": str(dev), "sizes": [n_customers, n_articles]}))
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # --- the ranks ----------------------------------------------------------
    t0 = time.perf_counter()
    spawn_ranks(process_rank, (str(workdir), seed, repeats), PROC_RANKS,
                PROC_TIMEOUT, "phase 14")
    ranks_s = time.perf_counter() - t0
    results = []
    for r in range(PROC_RANKS):
        path = workdir / f"rank{r}.json"
        require(path.exists(), f"rank {r} printed no result")
        results.append(json.loads(path.read_text()))

    # --- (a) bit for bit against phase 12's one-process index --------------
    for r in range(PROC_RANKS):
        require(results[r]["foreign_modules"] == [],
                f"rank {r} imported {results[r]['foreign_modules']}")
        with np.load(workdir / f"answers{r}.npz") as z:
            for key, want in ref.items():
                require(z[key].tobytes() == want.tobytes(),
                        f"rank {r}: {key} differs from the one-process "
                        "sharded index")
    # --- (b) the same recall everywhere -------------------------------------
    final = {str(k): v for k, v in ctx["final"].items()}
    want_sharded = {str(k): v for k, v in ref_sharded.items()}
    ev = [x["eval"] for x in results]
    for r, e in enumerate(ev):
        require(e["recall"] == final,
                f"rank {r}: recall {e['recall']} != phase 10's {final}")
        require(e["recall_sharded"] == want_sharded,
                f"rank {r}: sharded recall {e['recall_sharded']} != the "
                f"one-process (2, 2) runner's {want_sharded}")
        require(e["to_local_digest"] == ev[0]["to_local_digest"],
                "to_local() assembled another catalog on a rank")
        require(len(e["shard_files"]) == 2, f"shard files {e['shard_files']}")
    # --- (c) the ranks' replicated state bit for bit ------------------------
    for j, (path, *_) in enumerate(PROC_PATHS):
        rows = [x["train"][j] for x in results]
        require(all(r["replicated_prints"] == rows[0]["replicated_prints"]
                    and r["losses"] == rows[0]["losses"] for r in rows),
                f"{path}: the ranks' replicated state or losses differ")
    # --- (d) the runner over the group --------------------------------------
    rn = [x["runner"] for x in results]
    resumed = {str(k): v for k, v in ctx["mesh_resumed"].items()}
    for r, x in enumerate(rn):
        require(x["initial"] == rn[0]["initial"]
                and x["final"] == rn[0]["final"],
                f"rank {r}: the runner's recall differs between the ranks")
        require(x["reverse_recall"] == resumed,
                f"rank {r}: phase 13's checkpoint restored by the group gave "
                f"{x['reverse_recall']}, phase 13's run {resumed}")
    # before any step the group evaluates phase 13's initial model exactly;
    # after the epoch its recall is a reading: the ranks feed their own
    # shards in their own order (as JAX's runner does), and the order alone
    # moves recall@100: phase 13's one-process run reshuffled is printed
    # beside it
    mesh_final = {str(k): v for k, v in ctx["mesh_final"].items()}
    require(rn[0]["initial"] == {str(k): v for k, v in
                                 ctx["mesh_initial"].items()},
            f"the group runner began at {rn[0]['initial']}, phase 13's at "
            f"{ctx['mesh_initial']}")
    require(rn[0]["final"]["100"] > rn[0]["initial"]["100"],
            f"recall@100 over the group did not rise: {rn[0]}")
    other_order = modelling_runner(
        proc_runner_settings(ctx["mesh_settings"], workdir / "order"),
        mesh=make_mesh(2, 2, devices=[dev] * 4), distributed_index=True,
        device=dev, training_overrides={"shuffle_buffer_size": SHARD_ROWS})
    g = proc_runner_settings(ctx["mesh_settings"], workdir)
    one = evaluation_runner(
        dataclasses.replace(g, index_dirpath=str(workdir / "proc_one_index")),
        mesh=make_mesh(2, 2, devices=[dev] * 4), distributed_index=True,
        device=dev)
    require({str(k): v for k, v in one.items()} == rn[0]["final"],
            f"the group's checkpoint restored in one process gave {one}, "
            f"the group {rn[0]['final']}")
    loaded = load_distributed_index(g.index_dirpath,
                                    make_mesh(2, 2, devices=[dev] * 4))
    require(loaded.num_candidates == n, "the group's index does not load")
    del loaded
    launches = {}
    for x in results:
        for part in ("serve", "eval", "runner"):
            for k, v in x[part]["launches"].items():
                launches[k] = launches.get(k, 0) + v
    for kn in ("bin_max2_first_round", "bin_max2_round",
               "bin_max2_scaled_single_pass"):
        require(dev.type != "cuda" or launches.get(kn, 0) > 0,
                f"phase 14 launched {launches}")
    phase13 = {row["path"]: row.get("median_step_ms") for row in mesh_rows}
    sharded_ms = ctx.get("sharded_ms", {})
    emit({"processes": {
        "ranks": PROC_RANKS, "backend": results[0]["backend"],
        "device": results[0]["device"], "ranks_s": ranks_s,
        "rank_seconds": [x["seconds"] for x in results],
        "peak_mem_gb": [x["peak_mem_gb"] for x in results],
        "serve_ms": {k: {"ranks": [x["serve"]["ms"][k] for x in results],
                         "phase12_one_process": sharded_ms.get(k)}
                     for k in results[0]["serve"]["ms"]},
        "serve_bitwise_vs_phase12": True,
        "recall": final, "recall_sharded": want_sharded,
        "eval_runner_s": [[x["eval"]["runner_s"], x["eval"]["runner_sharded_s"]]
                          for x in results],
        "train": [{"path": path,
                   "median_step_ms": [x["train"][j]["median_step_ms"]
                                      for x in results],
                   "phase13_one_process_ms": phase13.get(path),
                   "bytes_sent_per_step": [x["train"][j]["bytes_sent_per_step"]
                                           for x in results],
                   "exchange_ms_per_step": [
                       x["train"][j]["exchange_ms_per_step"] for x in results],
                   "profile_rank0": results[0]["train"][j]["profile"],
                   "peak_mem_gb": [x["train"][j]["peak_mem_gb"]
                                   for x in results]}
                  for j, (path, *_) in enumerate(PROC_PATHS)],
        "runner": {"initial": rn[0]["initial"], "final": rn[0]["final"],
                   "phase13_final": mesh_final,
                   "phase13_other_order_final": {
                       str(k): v for k, v in other_order["final"].items()},
                   "other_order": f"shuffle_buffer_size={SHARD_ROWS}",
                   "reverse_recall": rn[0]["reverse_recall"],
                   "phase13_resumed_final": resumed,
                   "one_process_restore": {str(k): v for k, v in one.items()},
                   "runner_s": [x["runner_s"] for x in rn],
                   "eval_runner_s": [x["eval_runner_s"] for x in rn],
                   "exchange": [x["exchange"] for x in rn]},
        "launches": launches}})
    return launches


# --- phase 17: one process over several distinct devices --------------------

HOST = torch.device("cpu")
# (path, its single-device counterpart in TRAIN_PATHS, (data, model),
# row-sharded features) over the card and the host CPU, by counterpart
CARD_HOST_PATHS = (
    ("dp_dense_adagrad", "dense_adagrad", (2, 1), []),
    ("row_sharded_dense_adagrad_1x2", "dense_adagrad", (1, 2), MESH_SHARDED),
    ("dp_sparse_adagrad", "sparse_adagrad", (2, 1), []),
    ("row_sharded_sparse_1x2", "sparse_adagrad", (1, 2), MESH_SHARDED),
)
# the dense paths copy the 702 MB customer table, or update half of it on
# the host, each step: replays of 1 step (2 until phase 18 needed the time),
# not MESH_STEPS
CARD_HOST_REPLAYS = {"dp_dense_adagrad": 1,
                     "row_sharded_dense_adagrad_1x2": 1}
SEVERAL_EVAL_ROWS = 2048  # the card + host runner's test rows: one batch
SEVERAL_SERVE_BATCHES = (1, 1024)


def card_paths(n):
    """Phase 17's paths over ``n`` cards: data-parallel at (n, 1),
    row-sharded at (1, n), and both row-sharded at (2, 2) where n = 4."""
    paths = [("dp_dense_adagrad", "dense_adagrad", (n, 1), []),
             ("row_sharded_dense_adagrad_1x%d" % n, "dense_adagrad", (1, n),
              MESH_SHARDED)]
    if n == 4:
        paths.append(("row_sharded_dense_adagrad_2x2", "dense_adagrad",
                      (2, 2), MESH_SHARDED))
    paths += [("dp_sparse_adagrad", "sparse_adagrad", (n, 1), []),
              ("row_sharded_sparse_1x%d" % n, "sparse_adagrad", (1, n),
               MESH_SHARDED)]
    if n == 4:
        paths.append(("row_sharded_sparse_2x2", "sparse_adagrad", (2, 2),
                      MESH_SHARDED))
    return tuple(paths)


def first_rows(src, dst, n, shard_rows=SHARD_ROWS):
    """The first ``n`` rows of the shards in ``src`` as shards of
    ``shard_rows`` rows in ``dst``."""
    from hm_retrieval_tpu_torch.data import ShardDataset

    write_shards(dst, next(ShardDataset(str(src)).iter_batches(n)),
                 shard_rows)


def several_devices_runner(ctx, mesh, dev, workdir, name):
    """Phase 17 (b) over ``mesh`` (see the module docstring). Returns the
    kernels' launches of the runner over the mesh."""
    from hm_retrieval_tpu_torch.data import ShardDataset, device_feed
    from hm_retrieval_tpu_torch.models import TwoTowerModel
    from hm_retrieval_tpu_torch.models.train_path import make_mesh_trainer
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt
    from hm_retrieval_tpu_torch.parallel import make_mesh
    from hm_retrieval_tpu_torch.runners import (
        CheckpointManager, evaluation_runner, modelling_runner,
    )
    from hm_retrieval_tpu_torch.schema import Schema

    cuda = dev.type == "cuda"
    base = ctx["mesh_settings"]  # phase 13 (c)'s: both id tables sharded
    w = workdir / name
    test_dir = w / "test"
    first_rows(base.test_shards_dirpath, test_dir, SEVERAL_EVAL_ROWS)
    settings = dataclasses.replace(
        base, test_shards_dirpath=str(test_dir),
        checkpoint_dirpath=str(w / "checkpoints"),
        model_dirpath=str(w / "model"), index_dirpath=str(w / "index"),
        tensorboard_logs_dir=None, profile_steps=None)
    schema = Schema.load(settings.schema_dirpath)
    tc = schema.training_config
    # --- the main path: the runner over the mesh, counts from 0 ------------
    sync_all()
    bt.reset_launches()
    qt.reset_launches()
    t0 = time.perf_counter()
    results = modelling_runner(settings, mesh=mesh, distributed_index=True,
                               device=dev)
    sync_all()
    runner_s = time.perf_counter() - t0
    launches = kernel_counts()
    # ----------------------------------------------------------------------
    for when in ("initial", "final"):
        check_runner_recall(when, results[when], schema.model_config.ks)
    require(results["final"][100] > results["initial"][100],
            f"{name}: recall@100 did not rise: {results}")
    require(not cuda or (launches["bin_max2_first_round"] > 0
                         and launches["bin_max2_round"] > 0),
            f"{name}: evaluate did not launch kernels 1-2: {launches}")
    require(all(v == 0 for k, v in launches.items()
                if k not in ("bin_max2_first_round", "bin_max2_round")),
            f"{name}: the runner launched other kernels: {launches}")
    steps = RUNNER_TRAIN_ROWS // tc.train_batch_size
    ckpt = CheckpointManager(settings.checkpoint_dirpath, device=dev)
    require(ckpt.latest_step() == steps,
            f"{name}: checkpoint at step {ckpt.latest_step()}, not {steps}")
    ckpt.close()
    # the checkpoint over the card repeated (the same shards, so the same
    # padded rows), on every test row: beside phase 13's recall
    S = mesh.shape["model"]
    t0 = time.perf_counter()
    full = evaluation_runner(
        dataclasses.replace(settings,
                            test_shards_dirpath=base.test_shards_dirpath,
                            index_dirpath=str(w / "index_card")),
        mesh=make_mesh(1, S, devices=[dev] * S), distributed_index=True,
        device=dev)
    full_eval_s = time.perf_counter() - t0

    # --- save, restore, resume one step: the bits of the unbroken run -----
    def trainer():
        model = TwoTowerModel.create_from_schema(schema, device=dev)
        return make_mesh_trainer(model, tc, mesh)

    batches = list(device_feed(itertools.islice(ShardDataset(
        settings.train_shards_dirpath).iter_batches(tc.train_batch_size), 2),
        mesh=mesh))
    state, step = trainer()
    state = CheckpointManager(settings.checkpoint_dirpath,
                              device=dev).restore(state)
    placed = check_placement(f"{name} restored", state, mesh)
    state, _ = step(state, batches[0])
    saver = CheckpointManager(str(w / "resume"), device=dev)
    saver.save(state.step, state)
    saver.close()
    state, _ = step(state, batches[1])  # the unbroken run
    resumed, step_r = trainer()
    resumed = CheckpointManager(str(w / "resume"), device=dev).restore(
        resumed)
    check_placement(f"{name} resumed", resumed, mesh)
    resumed, _ = step_r(resumed, batches[1])
    require(resumed.step == state.step == steps + 2,
            f"{name}: steps {resumed.step} / {state.step}")
    require(all(torch.equal(a, b) for a, b in zip(all_tensors(resumed),
                                                  all_tensors(state))),
            f"{name}: the resumed state differs from the unbroken run's")
    require(all(a.device == b.device for a, b in zip(all_tensors(resumed),
                                                     all_tensors(state))),
            f"{name}: a resumed tensor lies on another device")
    emit({"several_devices_runner": {
        "name": name, "mesh": mesh.shape,
        "devices": [str(d) for d in mesh.devices.reshape(-1)],
        "sharded": MESH_SHARDED, "distributed_index": True, "steps": steps,
        "runner_s": runner_s, "test_rows": SEVERAL_EVAL_ROWS,
        "initial": results["initial"], "final": results["final"],
        "all_test_rows_final": full, "all_test_rows_eval_s": full_eval_s,
        "phase_13_final": ctx["mesh_final"], "launches": launches,
        "placement": placed, "resumed_one_step_bitwise": True,
        "resumed_step": resumed.step}})
    return launches


def several_devices_index(ctx, mesh, dev, name):
    """Phase 17 (c) over ``mesh`` (see the module docstring). Returns the
    kernels' launches of the sharded indices' serves, the answers
    (``{index: {B: (scores, ids)}}``) and the queries."""
    from hm_retrieval_tpu_torch.indices import (
        DistributedBruteForceIndex, DistributedQuantizedIndex,
        QuantizedIndex,
    )
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt

    model, exact1, tc, test_ds = (ctx["model"], ctx["index"], ctx["tc"],
                                  ctx["test_ds"])
    cuda = dev.type == "cuda"
    n, k = exact1.num_candidates, SERVE_K
    shards = mesh.shape["model"]
    ids = exact1.identifiers[:n].cpu().numpy()
    emb = exact1.embeddings[:n]
    first = to_device(next(test_ds.iter_batches(tc.test_batch_size)), dev)
    with torch.no_grad():
        q_all = model.query_forward(first)[: max(SEVERAL_SERVE_BATCHES)]
    t0 = time.perf_counter()
    single = {
        "exact": exact1, "quantized": ctx["qindex"],
        "rounds": QuantizedIndex(k, ids, emb, method="pallas",
                                 pallas_rounds=MAX_ROUNDS, device=dev),
    }
    sharded = {
        "exact": DistributedBruteForceIndex(k, ids, emb, mesh=mesh,
                                            method="pallas"),
        "quantized": DistributedQuantizedIndex(k, ids, emb, mesh=mesh,
                                               method="pallas"),
        "rounds": DistributedQuantizedIndex(k, ids, emb, mesh=mesh,
                                            method="pallas",
                                            pallas_rounds=MAX_ROUNDS),
    }
    sync_all()
    build_s = time.perf_counter() - t0
    homes = {}  # each shard's device: the exact rows, the quantized codes
    for name_, index in sharded.items():
        rows = index._emb if name_ == "exact" else index._placed[0]
        homes[name_] = [str(rows.shard(s).device) for s in range(shards)]
        require(homes[name_] == [str(mesh.model_device(s))
                                 for s in range(shards)],
                f"{name}: {name_}'s shards lie on {homes[name_]}")
    # --- the main path: counts from 0 --------------------------------------
    bt.reset_launches()
    qt.reset_launches()
    answers, per_index, serve_ms = {}, {}, {}
    for name_, index in sharded.items():
        answers[name_], per_index[name_], serve_ms[name_] = {}, {}, {}
        for B in SEVERAL_SERVE_BATCHES:
            before = kernel_counts()
            sync_all()
            t0 = time.perf_counter()
            answers[name_][B] = index.topk_from_embeddings(q_all[:B])
            sync_all()
            serve_ms[name_][B] = (time.perf_counter() - t0) * 1e3
            per_index[name_][B] = {kn: v - before[kn]
                                   for kn, v in kernel_counts().items()
                                   if v > before[kn]}
    launches = kernel_counts()
    # ----------------------------------------------------------------------
    want_kernels = {
        "exact": ("bin_max2_first_round", "bin_max2_round"),
        "quantized": SINGLE_PASS_KERNELS[:2],
        "rounds": ROUNDS_KERNELS,
    }
    for name_, kernels in want_kernels.items():
        for kn in kernels:
            got = sum(by_b.get(kn, 0) for by_b in per_index[name_].values())
            require(not cuda or got > 0,
                    f"{name}: sharded {name_} launched {per_index[name_]}")
    held = {}
    for B in SEVERAL_SERVE_BATCHES:
        q = q_all[:B]
        exact_scores = bt.plain_scores(q.to(torch.bfloat16),
                                       emb.to(torch.bfloat16))
        fp32_top = torch.topk(bt.plain_scores(q, emb), k, dim=1).indices + 1
        got = answers["exact"][B]
        with plain_exact():
            want = sharded["exact"].topk_from_embeddings(q)
        answers_ok(*got, k, n)
        one = single["exact"].topk_from_embeddings(q)
        held[f"exact_B{B}"] = {
            "vs_plain": compare_ranked(got[0], got[1] - 1, want[0],
                                       want[1] - 1, exact_scores, gap=TOL),
            "vs_single": compare_ranked(got[0], got[1] - 1, one[0],
                                        one[1] - 1, exact_scores, gap=TOL)}
        del exact_scores
        for name_, rounds in (("quantized", False), ("rounds", True)):
            got, st = hold_sharded_quantized(sharded[name_], q, rounds,
                                             shards=shards)
            answers_ok(*got, k, n)
            one = single[name_].topk_from_embeddings(q)
            st["recall_vs_fp32"] = recall_vs(got[1], fp32_top)
            st["single_recall_vs_fp32"] = recall_vs(one[1], fp32_top)
            require(st["recall_vs_fp32"] >= st["single_recall_vs_fp32"]
                    - 0.005, f"{name}: sharded {name_} at B={B} loses "
                    f"recall: {st}")
            held[f"{name_}_B{B}"] = st
        del fp32_top
    emit({"several_devices_index": {
        "name": name, "catalog": n, "k": k, "mesh": mesh.shape,
        "shard_devices": homes, "build_s": build_s, "launches": launches,
        "per_index": per_index, "held": held, "serve_wall_ms": serve_ms}})
    return launches, answers, q_all


def phase_several_devices(ctx, seed, dev, workdir, n_customers=N_CUSTOMERS,
                          n_articles=N_ARTICLES):
    """Phase 17 (see the module docstring). Returns each kernel's launches
    over (b) and (c), on the card and the host, and over every card where
    there are several."""
    from hm_retrieval_tpu_torch.parallel import make_mesh

    laps = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        now = time.perf_counter()
        laps[name] = now - t0
        t0 = now

    def card_host(shape):
        return [dev, HOST] if shape[0] * shape[1] == 2 else None

    phase_mesh_training(seed, dev, n_customers, n_articles,
                        paths=CARD_HOST_PATHS, cells=card_host, timed=False,
                        replays=CARD_HOST_REPLAYS,
                        tag="several_devices_training")
    lap("a_card_host")
    pair = make_mesh(1, 2, devices=[dev, HOST])
    launches = several_devices_runner(ctx, pair, dev, workdir, "card_host")
    lap("b_card_host")
    for kn, v in several_devices_index(ctx, pair, dev,
                                       "card_host")[0].items():
        launches[kn] += v
    lap("c_card_host")
    # a power of two of the cards, so that each mesh axis divides B
    visible = torch.cuda.device_count() if dev.type == "cuda" else 0
    cards = 1 << (visible.bit_length() - 1) if visible else 0
    if cards >= 2:
        # make_mesh()'s cells: every card once
        every = list(make_mesh().devices.reshape(-1))
        phase_mesh_training(
            seed, dev, n_customers, n_articles, paths=card_paths(cards),
            cells=lambda shape: every[:shape[0] * shape[1]], timed=True,
            tag="several_cards_training", same_device_bits=True)
        lap("a_cards")
        row = make_mesh(1, cards, devices=every[:cards])
        for kn, v in several_devices_runner(ctx, row, dev, workdir,
                                            "cards").items():
            launches[kn] += v
        lap("b_cards")
        for kn, v in several_devices_index(ctx, row, dev,
                                           "cards")[0].items():
            launches[kn] += v
        lap("c_cards")
    emit({"several_devices": {"visible_cards": visible, "cards": cards,
                              "seconds": laps}})
    return launches


# --- phase 18: ranks of a process group, each over several devices ----------

RANKS18 = 2  # ranks of phase 18's group
RANKS18_TIMEOUT = 480  # seconds the parent waits for them
# held steps a path (each from the single-device chain's state), replayed
# twice; then host-clock steps through the feed (card + host), or CUDA-event
# steps where every cell is a card
R18_STEPS = {"sparse": 3, "dense": 1}
R18_TIMED = {"sparse": 5, "dense": 0}
R18_CARDS_TIMED = 20
# batches of the stream, the same in every process: the held steps' first
R18_BATCHES = max(R18_STEPS.values()) + R18_CARDS_TIMED
# (path, its single-device counterpart in TRAIN_PATHS, (data, model),
# row-sharded features), grouped by counterpart: over 2 ranks, (2, 2) is a
# data row a rank, (4, 1) two data rows a rank, (1, 4) two columns a rank
R18_PATHS = (
    ("row_sharded_sparse_2x2", "sparse_adagrad", (2, 2), MESH_SHARDED),
    ("dp_sparse_adagrad", "sparse_adagrad", (4, 1), []),
    ("row_sharded_sparse_1x4", "sparse_adagrad", (1, 4), MESH_SHARDED),
    ("row_sharded_dense_2x2", "dense_adagrad", (2, 2), MESH_SHARDED),
    ("dp_dense_adagrad", "dense_adagrad", (4, 1), []),
)


def r18_prints(state, dev):
    """The fingerprint of each of this process's pieces of a training state
    (``local_pieces``), ``<key>@<first row>``, computed on ``dev``."""
    return {f"{k}@{lo}": fingerprint(t.detach().to(dev))
            for k, pieces in local_pieces(state).items() for lo, t in pieces}


def r18_batches(seed, sizes):
    """Phase 13's stream: ``R18_BATCHES`` host batches of TRAIN_B rows."""
    rng = np.random.default_rng(seed + 13)
    probs, logq = article_popularity(sizes[1])
    cols, _ = train_columns(rng, R18_BATCHES * TRAIN_B, *sizes, probs)
    cols.pop("purchase_history")
    host = [{k: v[i * TRAIN_B:(i + 1) * TRAIN_B] for k, v in cols.items()}
            for i in range(R18_BATCHES)]
    return host, logq


def r18_chain(single_name, host, n, logq, dev, sizes):
    """The single-device chain on the card: its state before each of ``n``
    steps and after the last (unpadded rows), and its losses."""
    from hm_retrieval_tpu_torch.models import make_single_device_trainer

    fields = {name: f for name, f, _ in TRAIN_PATHS}
    tc = training_config(fields[single_name], check=True)
    model = train_model(*sizes, logq, False, dev)
    state, step = make_single_device_trainer(model, tc)
    rows_of = {n_: p.shape[0] for n_, p in state.params.items()}
    chain = [{k: v.clone() for k, v in state_tensors(state, rows_of).items()}]
    losses = []
    for b in host[:n]:
        state, m = step(state, to_device(b, dev))
        losses.append(m["loss"])
        chain.append({k: v.clone() for k, v in
                      state_tensors(state, rows_of).items()})
    del model, state, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return tc, chain, torch.stack(losses)


def r18_reference(paths, seed, dev, sizes, cells):
    """Phase 18 (a)'s reference in the parent: each path over ONE process's
    mesh of the group's grid (``cells``), each held step from the
    single-device chain's state, and the fingerprint of every tensor after
    it."""
    from hm_retrieval_tpu_torch.models.train_path import make_mesh_trainer
    from hm_retrieval_tpu_torch.parallel import make_mesh

    host, logq = r18_batches(seed, sizes)
    out, chains = {}, {}
    for path, single_name, (D, S), sharded in paths:
        n = R18_STEPS["sparse" if "sparse" in path else "dense"]
        if single_name not in chains:
            chains.clear()
            chains[single_name] = r18_chain(single_name, host, n, logq, dev,
                                            sizes)
        tc, chain, _ = chains[single_name]
        mesh = make_mesh(D, S, devices=cells[:D * S])
        model = train_model(*sizes, logq, False, dev)
        state, step = make_mesh_trainer(
            model, dataclasses.replace(tc, sharded_embedding_features=sharded),
            mesh)
        prints, losses = [], []
        for i in range(n):
            state = load_values(state, chain[i], i)
            state, m = step(state, to_device(host[i], dev))
            losses.append(float(m["loss"]))
            prints.append(r18_prints(state, dev))
        out[path] = {"prints": prints, "losses": losses,
                     "chain_print": [fingerprint(v) for _, v in
                                     sorted(chain[n].items())]}
        del model, state, step
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def r18_train_path(path, single_name, shape, sharded, host, logq, dev,
                   sizes, cells, chains, events):
    """Phase 18 (a) for one path on this rank: ``cells`` its devices (None:
    its block of cards); ``chains`` caches the single-device chain by
    counterpart. ``events``: time with CUDA events (every cell a card),
    else on the host clock."""
    from hm_retrieval_tpu_torch.data import device_feed
    from hm_retrieval_tpu_torch.models.train_path import make_mesh_trainer
    from hm_retrieval_tpu_torch.parallel import make_mesh

    kind = "sparse" if "sparse" in path else "dense"
    n = R18_STEPS[kind]
    if single_name not in chains:
        chains.clear()
        chains[single_name] = r18_chain(single_name, host, n, logq, dev,
                                        sizes)
    tc, chain, single_losses = chains[single_name]
    D, S = shape
    mesh = (make_mesh(D, S) if cells is None
            else make_mesh(D, S, devices=cells))
    rows = mesh.local_rows()
    b = TRAIN_B // D

    def local(batch):
        """This rank's rows of a global batch: its data rows'."""
        return {k: v[rows[0] * b:(rows[-1] + 1) * b] for k, v in
                batch.items()}

    model = train_model(*sizes, logq, False, dev)
    state, step = make_mesh_trainer(
        model, dataclasses.replace(tc, sharded_embedding_features=sharded),
        mesh)
    sync_all()
    placed = check_placement(path, state, mesh)
    row_sharded = sorted(k for k, v in state_values(state).items()
                         if hasattr(v, "shards"))
    require(hold_pieces(f"{path} initial", state, chain[0]) == 0.0,
            f"{path}: the initial state differs from the single device's")
    saved = [t.detach().clone() for p in local_pieces(state).values()
             for _, t in p]
    # --- each held step from the single-device chain's state ---------------
    worst, losses, prints, sent, crossed, step_ms = 0.0, [], [], [], [], []
    for i in range(n):
        state = load_pieces(state, chain[i], i)
        batch = to_device(local(host[i]), dev)
        sync_all()
        t0 = time.perf_counter()
        with exchanged() as ex, CrossDeviceBytes() as cx:
            state, m = step(state, batch)
            sync_all()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        sent.append(ex["bytes"])
        crossed.append(cx.bytes)
        losses.append(float(m["loss"]))
        worst = max(worst, hold_pieces(f"{path} step {i}", state,
                                       chain[i + 1]))
        prints.append(r18_prints(state, dev))
    require(all(np.isfinite(losses)), f"{path}: a loss is NaN")
    require(np.allclose(losses, single_losses.tolist(), rtol=1e-5, atol=0),
            f"{path}: losses {losses} against the single device's "
            f"{single_losses.tolist()}")
    # --- replays from the initial state, bit-identical --------------------
    runs = []
    for _ in range(2):
        with torch.no_grad():
            for t, s0 in zip([t for p in local_pieces(state).values()
                              for _, t in p], saved):
                t.copy_(s0)
        state = state._replace(step=0)
        run_losses = []
        for h in host[:n]:
            state, m = step(state, to_device(local(h), dev))
            run_losses.append(float(m["loss"]))
        runs.append((r18_prints(state, dev), run_losses))
    require(runs[0] == runs[1], f"{path}: the replays differ")
    untouched, pad_rows = check_untouched(path, state, saved, chain[0],
                                          host[:n])
    del runs, saved
    # --- time through the feed --------------------------------------------
    timed = R18_CARDS_TIMED if events else R18_TIMED[kind]
    ms, peak = [], None
    if timed:
        cards = sorted({d.index for d in mesh.devices[
            mesh.ranks == mesh.process_index] if d.type == "cuda"})
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)
        feed = [local(host[n + (i % (len(host) - n))]) for i in range(timed)]
        for fb in device_feed(iter(feed), mesh=mesh):
            if events:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                state, _ = step(state, fb)
                ev[1].record()
                ms.append(ev)
            else:
                sync_all()
                t0 = time.perf_counter()
                state, _ = step(state, fb)
                sync_all()
                ms.append((time.perf_counter() - t0) * 1e3)
        sync_all()
        if events:
            ms = [x.elapsed_time(y) for x, y in ms]
        peak = {c: torch.cuda.max_memory_allocated(c) / 1e9 for c in cards}
    del model, state, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {
        "path": path, "single_device": single_name,
        "mesh": {"data": D, "model": S}, "rows": rows,
        "columns": mesh.local_cols(),
        "cells": [str(mesh.devices[d, s]) for d in rows
                  for s in mesh.local_cols()],
        "sharded": sharded, "local_B": b * len(rows), "global_B": TRAIN_B,
        "losses": losses, "single_losses": single_losses.tolist(),
        "max_abs_err_per_step": worst, "rtol": TRAIN_RTOL,
        "atol": TRAIN_ATOL, "prints": prints, "replay_bitwise": True,
        "replay_steps": n, "untouched_rows_checked": untouched,
        "pad_rows": pad_rows, "placement": placed,
        "row_sharded": row_sharded, "exchange_bytes_per_step": sent,
        "cross_device_bytes_per_step": crossed,
        "held_step_ms": step_ms,
        "median_held_step_ms": statistics.median(step_ms),
        "timed_steps": len(ms),
        ("median_step_ms" if events else "median_host_clock_step_ms"):
            statistics.median(ms) if ms else None,
        "peak_gb_by_card": peak,
        "chain_print": [fingerprint(v) for _, v in sorted(chain[n].items())],
    }


def r18_runner(rank, spec, dev, cells):
    """Phase 18 (b) on one rank: ``modelling_runner`` over (2, 2), data row
    r here, then one step from the group's checkpoint."""
    from hm_retrieval_tpu_torch.data import ShardDataset
    from hm_retrieval_tpu_torch.models import TwoTowerModel
    from hm_retrieval_tpu_torch.models.train_path import make_mesh_trainer
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt
    from hm_retrieval_tpu_torch.parallel import make_mesh
    from hm_retrieval_tpu_torch.runners import (
        CheckpointManager, modelling_runner,
    )
    from hm_retrieval_tpu_torch.schema import Schema
    from hm_retrieval_tpu_torch.utils.settings import Settings

    settings = Settings.from_json(spec["runner_settings"])
    mesh = (make_mesh(2, 2) if cells is None
            else make_mesh(2, 2, devices=cells))
    require(mesh.local_rows() == [rank], f"rank {rank}: rows "
            f"{mesh.local_rows()}")
    # --- the main path: counts from 0 --------------------------------------
    sync_all()
    bt.reset_launches()
    qt.reset_launches()
    with exchanged() as ex:
        t0 = time.perf_counter()
        res = modelling_runner(settings, mesh=mesh, distributed_index=True,
                               device=dev)
        sync_all()
        runner_s = time.perf_counter() - t0
    launches = kernel_counts()
    # ----------------------------------------------------------------------
    schema = Schema.load(settings.schema_dirpath)
    tc = schema.training_config
    model = TwoTowerModel.create_from_schema(schema, device=dev)
    state, step = make_mesh_trainer(model, tc, mesh)
    state = CheckpointManager(settings.checkpoint_dirpath,
                              device=dev).restore(state)
    placed = check_placement("runner restored", state, mesh)
    batch = next(ShardDataset(settings.train_shards_dirpath,
                              process_index=rank, process_count=RANKS18)
                 .iter_batches(tc.train_batch_size // RANKS18))
    state, m = step(state, to_device(batch, dev))
    prints = r18_prints(state, dev)
    return {"mesh": [2, 2], "row": rank,
            "initial": {str(k): v for k, v in res["initial"].items()},
            "final": {str(k): v for k, v in res["final"].items()},
            "runner_s": runner_s, "launches": launches, "exchange": ex,
            "restored_step": state.step, "restored_loss": float(m["loss"]),
            "restored_prints": prints, "placement": placed}


def r18_index(rank, spec, dev, cells):
    """Phase 18 (c) on one rank: the exact, one-pass and 8-round sharded
    indices over (1, 4), shards 2r and 2r + 1 here."""
    from hm_retrieval_tpu_torch.indices import (
        DistributedBruteForceIndex, DistributedQuantizedIndex,
    )
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt
    from hm_retrieval_tpu_torch.parallel import make_mesh

    with np.load(spec["catalog"]) as z:
        ids, emb = z["identifiers"], z["embeddings"]
    q_all = torch.from_numpy(np.load(spec["queries"])).to(dev)
    mesh = (make_mesh(1, SHARDS) if cells is None
            else make_mesh(1, SHARDS, devices=cells))
    mine = [2 * rank, 2 * rank + 1]
    require(mesh.local_cols() == mine, f"rank {rank} holds columns "
            f"{mesh.local_cols()}")
    t0 = time.perf_counter()
    indices = {
        "exact": DistributedBruteForceIndex(SERVE_K, ids, emb, mesh=mesh,
                                            method="pallas"),
        "quantized": DistributedQuantizedIndex(SERVE_K, ids, emb, mesh=mesh,
                                               method="pallas"),
        "rounds": DistributedQuantizedIndex(SERVE_K, ids, emb, mesh=mesh,
                                            method="pallas",
                                            pallas_rounds=MAX_ROUNDS),
    }
    sync_all()
    build_s = time.perf_counter() - t0
    # --- the main path: counts from 0 --------------------------------------
    bt.reset_launches()
    qt.reset_launches()
    answers, per_index, ms = {}, {}, {}
    with exchanged() as ex:
        for name, ix in indices.items():
            before = kernel_counts()
            for B in SEVERAL_SERVE_BATCHES:
                sync_all()
                t1 = time.perf_counter()
                v, i = ix.topk_from_embeddings(q_all[:B])
                sync_all()
                ms[f"{name}_B{B}"] = (time.perf_counter() - t1) * 1e3
                answers[f"{name}_B{B}_scores"] = v.cpu().numpy()
                answers[f"{name}_B{B}_ids"] = i.cpu().numpy()
            per_index[name] = {kn: c - before[kn]
                               for kn, c in kernel_counts().items()
                               if c > before[kn]}
    launches = kernel_counts()
    # ----------------------------------------------------------------------
    np.savez(Path(spec["workdir"]) / f"answers18_{rank}.npz", **answers)
    return {"mesh": [1, SHARDS], "columns": mine, "build_s": build_s,
            "launches": launches, "per_index": per_index,
            "serve_wall_ms": ms, "exchange": ex}


def ranks_rank(rank, workdir):
    """Phase 18's rank ``rank``: joins the group, runs (a)-(c) over its
    cells and writes its results to ``workdir/rank18_{rank}.json``."""
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist

    from hm_retrieval_tpu_torch.parallel.mesh import (
        initialize_multihost, local_devices,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    workdir = Path(workdir)
    spec = json.loads((workdir / "spec18.json").read_text())
    torch.set_num_threads(spec["threads"])
    on_card = torch.device(spec["device"]).type == "cuda"
    dev = initialize_multihost(f"file://{workdir / 'rdzv18'}", RANKS18, rank,
                               device=None if on_card else "cpu")
    require(dist.get_backend() == spec["backend"],
            f"rank {rank} over {dist.get_backend()}, not {spec['backend']}")
    # the card and the host, or (None) make_mesh()'s default: the block
    cells = [dev, HOST] if spec["cells"] == "card_host" else None
    events = spec["cells"] == "cards"
    t0 = time.perf_counter()
    out = {"rank": rank, "device": str(dev), "backend": dist.get_backend(),
           "local_devices": [str(d) for d in local_devices()],
           "world": dist.get_world_size(), "train": [], "seconds": {}}
    sizes = spec["sizes"]
    host, logq = r18_batches(spec["seed"], sizes)
    chains = {}
    for path, single_name, shape, sharded in R18_PATHS:
        row = r18_train_path(path, single_name, shape, sharded, host, logq,
                             dev, sizes, cells, chains, events)
        emit({"rank_training": {"rank": rank, **{
            k: v for k, v in row.items() if k != "prints"}}})
        out["train"].append(row)
    chains.clear()
    out["seconds"]["a"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    out["runner"] = r18_runner(rank, spec, dev, cells)
    out["seconds"]["b"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["index"] = r18_index(rank, spec, dev, cells)
    out["seconds"]["c"] = time.perf_counter() - t1
    out["seconds"]["all"] = time.perf_counter() - t0
    out["foreign_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "hm_retrieval_tpu"))
    emit({"rank_several_devices": {
        k: out[k] for k in ("rank", "device", "backend", "local_devices",
                            "world", "seconds", "foreign_modules")},
        "runner": {k: v for k, v in out["runner"].items()
                   if k != "restored_prints"},
        "index": out["index"]})
    (workdir / f"rank18_{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()


def ranks_over_cells(ctx, seed, dev, workdir, variant, n_customers,
                     n_articles):
    """Phase 18 for one ``variant``: "card_host" (each rank over the card
    and the host CPU) or "cards" (each rank over its block of two cards).
    Returns each kernel's launches over both ranks' (b) and (c)."""
    mine = torch.get_num_threads()
    threads = max(1, mine // RANKS18)
    # every reference runs on the ranks' thread count, for the host's bits
    torch.set_num_threads(threads)
    try:
        return ranks_over_grid(ctx, seed, dev, workdir, variant, n_customers,
                               n_articles, threads)
    finally:
        torch.set_num_threads(mine)


def ranks_over_grid(ctx, seed, dev, workdir, variant, n_customers,
                    n_articles, threads):
    """``ranks_over_cells``' work, the references run on ``threads``."""
    from hm_retrieval_tpu_torch.data import ShardDataset
    from hm_retrieval_tpu_torch.models import TwoTowerModel
    from hm_retrieval_tpu_torch.models.train_path import make_mesh_trainer
    from hm_retrieval_tpu_torch.parallel import make_mesh
    from hm_retrieval_tpu_torch.parallel.mesh import (
        choose_backend, rank_devices,
    )
    from hm_retrieval_tpu_torch.runners import (
        CheckpointManager, evaluation_runner,
    )
    from hm_retrieval_tpu_torch.schema import Schema

    w = workdir / f"ranks18_{variant}"
    w.mkdir()
    cards = variant == "cards"
    visible = torch.cuda.device_count() if dev.type == "cuda" else 0
    # the group's grid in rank order: each rank's first card (the one card,
    # or cuda:0 and cuda:2 on four) and the host, or every card
    firsts = [rank_devices(r, RANKS18)[0] if visible else dev
              for r in range(RANKS18)]
    cells = (list(make_mesh().devices.reshape(-1))[:4] if cards
             else [c for first in firsts for c in (first, HOST)])
    backend = choose_backend(dev.type, RANKS18, visible)
    sizes = [n_customers, n_articles]
    laps = {}
    t0 = time.perf_counter()
    # --- the references, in this process over the same grid ---------------
    ref_train = r18_reference(R18_PATHS, seed, dev, sizes, cells)
    laps["a_reference"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    ref_launches, ref_answers, q_all = several_devices_index(
        ctx, make_mesh(1, SHARDS, devices=cells), dev,
        f"ranks_reference_{variant}")
    laps["c_reference"] = time.perf_counter() - t1
    exact1 = ctx["index"]
    n = exact1.num_candidates
    np.savez(w / "catalog.npz", identifiers=exact1.identifiers[:n].cpu()
             .numpy(), embeddings=exact1.embeddings[:n].cpu().numpy())
    np.save(w / "queries.npy", q_all.cpu().numpy())
    base = ctx["mesh_settings"]  # phase 13 (c)'s: both id tables sharded
    # a shard a rank
    first_rows(base.test_shards_dirpath, w / "test", SEVERAL_EVAL_ROWS,
               SEVERAL_EVAL_ROWS // RANKS18)
    settings = dataclasses.replace(
        base, test_shards_dirpath=str(w / "test"),
        checkpoint_dirpath=str(w / "checkpoints"),
        model_dirpath=str(w / "model"), index_dirpath=str(w / "index"),
        tensorboard_logs_dir=None, profile_steps=None)
    settings.to_json(str(w / "runner_settings.json"))
    (w / "spec18.json").write_text(json.dumps({
        "workdir": str(w), "seed": seed, "sizes": sizes, "threads": threads,
        "cells": variant, "backend": backend, "device": str(dev),
        "catalog": str(w / "catalog.npz"), "queries": str(w / "queries.npy"),
        "runner_settings": str(w / "runner_settings.json")}))
    sync_all()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # --- the ranks ----------------------------------------------------------
    t1 = time.perf_counter()
    spawn_ranks(ranks_rank, (str(w),), RANKS18, RANKS18_TIMEOUT, "phase 18")
    laps["ranks"] = time.perf_counter() - t1
    results = []
    for r in range(RANKS18):
        path = w / f"rank18_{r}.json"
        require(path.exists(), f"phase 18: rank {r} printed no result")
        results.append(json.loads(path.read_text()))
        require(results[r]["foreign_modules"] == [],
                f"rank {r} imported {results[r]['foreign_modules']}")
    # --- (a) the one-process mesh's bits, every tensor after every step ---
    train_rows = []
    for j, (path, *_) in enumerate(R18_PATHS):
        rows = [x["train"][j] for x in results]
        want = ref_train[path]
        for r, row in enumerate(rows):
            require(row["chain_print"] == want["chain_print"],
                    f"{path}: rank {r}'s single-device chain differs from "
                    "this process's")
            for i, got in enumerate(row["prints"]):
                differ = sorted(k for k, v in got.items()
                                if want["prints"][i].get(k) != v)
                require(not differ, f"{path} step {i}: rank {r}'s {differ} "
                        "differ from the one-process mesh's")
            require(row["losses"] == want["losses"],
                    f"{path}: rank {r}'s losses {row['losses']} are not the "
                    f"one-process mesh's {want['losses']}")
        for i in range(len(want["prints"])):
            shared = [{k: v for k, v in x["prints"][i].items()
                       if k.split("@")[0] not in x["row_sharded"]}
                      for x in rows]
            require(all(p == shared[0] for p in shared),
                    f"{path} step {i}: the ranks' replicated state differs")
        train_rows.append({
            "path": path, "mesh": rows[0]["mesh"],
            "cells": [x["cells"] for x in rows],
            "max_abs_err_per_step": [x["max_abs_err_per_step"] for x in rows],
            "exchange_bytes_per_step": [x["exchange_bytes_per_step"]
                                        for x in rows],
            "cross_device_bytes_per_step": [
                x["cross_device_bytes_per_step"] for x in rows],
            "median_held_step_ms": [x["median_held_step_ms"] for x in rows],
            ("median_step_ms" if cards else "median_host_clock_step_ms"): [
                x.get("median_step_ms", x.get("median_host_clock_step_ms"))
                for x in rows],
            "peak_gb_by_card": [x["peak_gb_by_card"] for x in rows],
            "bits_equal_one_process": True,
            "tensors_compared": sum(len(p) for x in rows
                                    for p in x["prints"])})
    # --- (b) the runner over (2, 2) ---------------------------------------
    rn = [x["runner"] for x in results]
    for r, x in enumerate(rn):
        require(x["initial"] == rn[0]["initial"] and x["final"] ==
                rn[0]["final"], f"rank {r}: the runner's recall differs "
                "between the ranks")
    require(rn[0]["final"]["100"] > rn[0]["initial"]["100"],
            f"recall@100 over the group did not rise: {rn[0]}")
    b_launches = {}
    for x in rn:
        for k, v in x["launches"].items():
            b_launches[k] = b_launches.get(k, 0) + v
    require(dev.type != "cuda" or (b_launches["bin_max2_first_round"] > 0
                                   and b_launches["bin_max2_round"] > 0),
            f"(b): evaluate did not launch kernels 1-2: {b_launches}")
    require(all(v == 0 for k, v in b_launches.items()
                if k not in ("bin_max2_first_round", "bin_max2_round")),
            f"(b): the runner launched other kernels: {b_launches}")
    grid = make_mesh(2, 2, devices=cells)
    t1 = time.perf_counter()
    one = evaluation_runner(
        dataclasses.replace(settings, index_dirpath=str(w / "one_index")),
        mesh=grid, distributed_index=True, device=dev)
    laps["b_reference"] = time.perf_counter() - t1
    one = {str(k): v for k, v in one.items()}
    require(one == rn[0]["final"], f"the group's checkpoint restored in one "
            f"process gave {one}, the group {rn[0]['final']}")
    schema = Schema.load(settings.schema_dirpath)
    tc = schema.training_config
    model = TwoTowerModel.create_from_schema(schema, device=dev)
    state, step = make_mesh_trainer(model, tc, grid)
    state = CheckpointManager(settings.checkpoint_dirpath,
                              device=dev).restore(state)
    local_b = tc.train_batch_size // RANKS18
    parts = [next(ShardDataset(settings.train_shards_dirpath,
                               process_index=r, process_count=RANKS18)
                  .iter_batches(local_b)) for r in range(RANKS18)]
    batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    state, m = step(state, to_device(batch, dev))
    ref_prints = r18_prints(state, dev)
    for r, x in enumerate(rn):
        differ = sorted(k for k, v in x["restored_prints"].items()
                        if ref_prints.get(k) != v)
        require(not differ, f"(b): rank {r}'s step from the checkpoint "
                f"differs from one process's in {differ}")
        require(x["restored_loss"] == float(m["loss"]),
                f"(b): rank {r}'s loss from the checkpoint "
                f"{x['restored_loss']}, one process's {float(m['loss'])}")
    del model, state, step
    # --- (c) the sharded indices over (1, 4) --------------------------------
    ix = [x["index"] for x in results]
    for r in range(RANKS18):
        with np.load(w / f"answers18_{r}.npz") as z:
            for name, by_b in ref_answers.items():
                for B, (v, i) in by_b.items():
                    require(z[f"{name}_B{B}_scores"].tobytes()
                            == v.cpu().numpy().tobytes()
                            and z[f"{name}_B{B}_ids"].tobytes()
                            == i.cpu().numpy().tobytes(),
                            f"(c): rank {r}'s {name} at B={B} differs from "
                            "the one-process index over the same grid")
    c_launches = {}
    for x in ix:
        for k, v in x["launches"].items():
            c_launches[k] = c_launches.get(k, 0) + v
    for kn in ("bin_max2_first_round", "bin_max2_round") + \
            SINGLE_PASS_KERNELS[:2] + ROUNDS_KERNELS:
        require(dev.type != "cuda" or all(
            x["launches"].get(kn, 0) > 0 for x in ix),
            f"(c): {kn} was not launched on every rank: "
            f"{[x['launches'] for x in ix]}")
    launches = {k: b_launches.get(k, 0) + c_launches.get(k, 0)
                for k in set(b_launches) | set(c_launches)}
    laps["all"] = time.perf_counter() - t0
    emit({"ranks_several_devices": {
        "variant": variant, "ranks": RANKS18,
        "backend": results[0]["backend"],
        "cells": [str(c) for c in cells],
        "local_devices": [x["local_devices"] for x in results],
        "threads_a_rank": threads, "seconds": laps,
        "rank_seconds": [x["seconds"] for x in results],
        "train": train_rows,
        "runner": {"initial": rn[0]["initial"], "final": rn[0]["final"],
                   "one_process_restore": one,
                   "restored_step_bitwise": True,
                   "runner_s": [x["runner_s"] for x in rn],
                   "exchange": [x["exchange"] for x in rn],
                   "launches": b_launches},
        "index": {"bitwise_vs_one_process": True,
                  "reference_launches": ref_launches,
                  "per_index": [x["per_index"] for x in ix],
                  "serve_wall_ms": [x["serve_wall_ms"] for x in ix],
                  "exchange": [x["exchange"] for x in ix],
                  "build_s": [x["build_s"] for x in ix],
                  "launches": c_launches}}})
    return launches


def phase_processes_nccl(ctx, seed, repeats, dev, workdir, sizes):
    """Phase 18's four-card branch, last part: phase 14's (a) and (c) over
    four NCCL ranks, a card each (phase 14's layout over NCCL). Returns each
    kernel's launches over the ranks' (a)."""
    from hm_retrieval_tpu_torch.indices import (
        DistributedBruteForceIndex, DistributedQuantizedIndex,
    )
    from hm_retrieval_tpu_torch.parallel import make_mesh

    ranks = 4
    w = workdir / "processes_nccl"
    w.mkdir()
    exact1, model, tc = ctx["index"], ctx["model"], ctx["tc"]
    n = exact1.num_candidates
    ids = exact1.identifiers[:n].cpu().numpy()
    emb = exact1.embeddings[:n]
    first = to_device(next(ctx["test_ds"].iter_batches(tc.test_batch_size)),
                      dev)
    with torch.no_grad():
        q_all = model.query_forward(first)[: max(SERVE_BATCHES)]
    np.savez(w / "catalog.npz", identifiers=ids, embeddings=emb.cpu().numpy())
    np.save(w / "queries.npy", q_all.cpu().numpy())
    # the reference: phase 12's one-process S = 4 indices on the one card
    mesh = make_mesh(1, SHARDS, devices=[dev] * SHARDS)
    ref = {}
    for name, ix in (
        ("exact", DistributedBruteForceIndex(SERVE_K, ids, emb, mesh=mesh,
                                             method="pallas")),
        ("quantized", DistributedQuantizedIndex(SERVE_K, ids, emb,
                                                mesh=mesh, method="pallas")),
    ):
        for B in SERVE_BATCHES:
            v, i = ix.topk_from_embeddings(q_all[:B])
            ref[f"{name}_B{B}_scores"] = v.cpu().numpy()
            ref[f"{name}_B{B}_ids"] = i.cpu().numpy()
    del mesh
    (w / "spec.json").write_text(json.dumps({
        "catalog": str(w / "catalog.npz"), "queries": str(w / "queries.npy"),
        "device": str(dev), "sizes": sizes, "ranks": ranks,
        # gloo on the CPU, where this rehearses
        "backend": "nccl" if dev.type == "cuda" else "gloo",
        "parts": ["serve", "train"]}))
    sync_all()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spawn_ranks(process_rank, (str(w), seed, repeats), ranks, PROC_TIMEOUT,
                "phase 18's four NCCL ranks")
    ranks_s = time.perf_counter() - t0
    results = []
    for r in range(ranks):
        path = w / f"rank{r}.json"
        require(path.exists(), f"NCCL rank {r} printed no result")
        results.append(json.loads(path.read_text()))
        with np.load(w / f"answers{r}.npz") as z:
            for key, want in ref.items():
                require(z[key].tobytes() == want.tobytes(),
                        f"NCCL rank {r}: {key} differs from the one-process "
                        "sharded index")
    for j, (path, *_) in enumerate(PROC_PATHS):
        rows = [x["train"][j] for x in results]
        require(all(r["replicated_prints"] == rows[0]["replicated_prints"]
                    and r["losses"] == rows[0]["losses"] for r in rows),
                f"{path}: the NCCL ranks' replicated state or losses differ")
    launches = {}
    for x in results:
        for k, v in x["serve"]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    emit({"processes_nccl": {
        "ranks": ranks, "backend": results[0]["backend"],
        "devices": [x["device"] for x in results], "ranks_s": ranks_s,
        "serve_bitwise_vs_phase12": True,
        "serve_ms": {k: [x["serve"]["ms"][k] for x in results]
                     for k in results[0]["serve"]["ms"]},
        "serve_exchange": [x["serve"]["exchange"] for x in results],
        "gloo_exchange_ms_phase14": 3.5,
        "train": [{"path": path,
                   "median_step_ms": [x["train"][j]["median_step_ms"]
                                      for x in results],
                   "bytes_sent_per_step": [x["train"][j]["bytes_sent_per_step"]
                                           for x in results],
                   "exchange_ms_per_step": [
                       x["train"][j]["exchange_ms_per_step"] for x in results],
                   "peak_mem_gb": [x["train"][j]["peak_mem_gb"]
                                   for x in results]}
                  for j, (path, *_) in enumerate(PROC_PATHS)],
        "launches": launches}})
    return launches


def phase_ranks_several_devices(ctx, seed, repeats, dev, workdir,
                                n_customers=N_CUSTOMERS,
                                n_articles=N_ARTICLES):
    """Phase 18 (see the module docstring). Returns each kernel's launches
    over both ranks' (b) and (c), and over the four-card branch's where
    the machine shows four cards."""
    launches = ranks_over_cells(ctx, seed, dev, workdir, "card_host",
                                n_customers, n_articles)
    visible = torch.cuda.device_count() if dev.type == "cuda" else 0
    if visible >= 4:
        for kn, v in ranks_over_cells(ctx, seed, dev, workdir, "cards",
                                      n_customers, n_articles).items():
            launches[kn] = launches.get(kn, 0) + v
        for kn, v in phase_processes_nccl(ctx, seed, repeats, dev, workdir,
                                          [n_customers, n_articles]).items():
            launches[kn] = launches.get(kn, 0) + v
    return launches


# --- phase 15: the front of the pipeline through the port ---------------------

PIPELINE_TRANSACTIONS = 3_000_000  # H&M's 31.8M, cut for time
PIPELINE_TRAIN_B = 2048
PIPELINE_SPLITS = ("train", "test", "candidates")
FRONT_STAGES = ("etl", "schema", "shards")


def pipeline_schema(n_product_types=N_PRODUCT_TYPES):
    """``hm_schema``'s widths with every vocab left for the schema stage
    to build, the purchase history and the standardised age as query
    features, logQ on, one epoch at ``PIPELINE_TRAIN_B``."""
    from hm_retrieval_tpu_torch.schema import (
        Feature, ModelConfig, Schema, TrainingConfig,
    )

    features = [
        Feature("customer_id", "categorical", "query", embedding_size=E),
        Feature("purchase_history", "sequence", "query", embedding_size=E,
                max_len=HISTORY_LEN, shared_vocab_with="article_id",
                pooling="mean"),
        Feature("age", "numeric", "query", standardize=True),
        Feature("article_id", "categorical", "candidate", embedding_size=E),
        Feature("product_type_name", "categorical", "candidate",
                embedding_size=16),
        Feature("colour_group_name", "categorical", "candidate",
                embedding_size=8),
    ]
    config = ModelConfig(E, ks=[10, 100, SERVE_K], query_tower_units=[256],
                         candidate_tower_units=[256])
    return Schema(features, config,
                  TrainingConfig(train_batch_size=PIPELINE_TRAIN_B,
                                 use_logq_correction=True))


def pipeline_settings(raw, workdir, **streaming):
    from hm_retrieval_tpu_torch.utils import Settings

    return Settings(
        transactions_filepath=raw["transactions"],
        articles_filepath=raw["articles"],
        customers_filepath=raw["customers"],
        train_start_date=raw["train_start"],
        train_end_date=raw["train_end"],
        test_start_date=raw["test_start"],
        test_end_date=raw["test_end"],
        train_data_filepath=str(workdir / "processed" / "train.npz"),
        test_data_filepath=str(workdir / "processed" / "test.npz"),
        schema_dirpath=str(workdir / "schema"),
        train_shards_dirpath=str(workdir / "shards" / "train"),
        test_shards_dirpath=str(workdir / "shards" / "test"),
        candidate_shards_dirpath=str(workdir / "shards" / "candidates"),
        model_dirpath=str(workdir / "model"),
        index_dirpath=str(workdir / "index"),
        baseline_index_dirpath=str(workdir / "baseline_index"),
        checkpoint_dirpath=str(workdir / "checkpoints"),
        tensorboard_logs_dir=None,
        profile_steps=None,
        history_max_len=HISTORY_LEN,
        **streaming,
    )


def peak_rss_gb():
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def run_front_stages(settings):
    """ETL, schema and shards through the port; each stage's seconds."""
    from hm_retrieval_tpu_torch.runners import (
        build_schema_runner, etl_runner, shard_writer_runner,
    )

    seconds = {}
    for name, run in (("etl", lambda: etl_runner(settings)),
                      ("schema", lambda: build_schema_runner(
                          settings, pipeline_schema())),
                      ("shards", lambda: shard_writer_runner(settings))):
        t0 = time.perf_counter()
        run()
        seconds[name] = time.perf_counter() - t0
    return seconds


def shard_digests(settings):
    """{split/file/array: sha256 of the array's bytes, dtype and shape}, and
    the bytes of every shard file."""
    import hashlib

    digests, nbytes = {}, 0
    for split in PIPELINE_SPLITS:
        d = Path(getattr(settings, f"{split}_shards_dirpath"
                         if split != "candidates"
                         else "candidate_shards_dirpath"))
        for path in sorted(d.glob("*.npz")):
            nbytes += path.stat().st_size
            with np.load(path) as z:
                for key in z.files:
                    a = z[key]
                    h = hashlib.sha256(a.tobytes())
                    h.update(f"{a.dtype.str}{a.shape}".encode())
                    digests[f"{split}/{path.name}/{key}"] = h.hexdigest()
    return digests, nbytes


def manifest(settings, split):
    attr = ("candidate_shards_dirpath" if split == "candidates"
            else f"{split}_shards_dirpath")
    with open(Path(getattr(settings, attr), "manifest.json")) as f:
        return json.load(f)


def phase_pipeline(seed, dev, workdir, n_customers=N_CUSTOMERS,
                   n_articles=N_ARTICLES,
                   n_transactions=PIPELINE_TRANSACTIONS):
    """Phase 15 (see the module docstring). Returns each kernel's launches
    in the modelling stage, driven from 0."""
    from hm_retrieval_tpu_torch.etl.transformations import load_dataframe
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt
    from hm_retrieval_tpu_torch.runners import (
        baseline_modelling_runner, modelling_runner,
    )
    from hm_retrieval_tpu_torch.schema import Schema
    from hm_retrieval_tpu_torch.utils.synthetic import generate_hm_like_csvs

    rss0 = peak_rss_gb()
    t0 = time.perf_counter()
    raw = generate_hm_like_csvs(str(workdir / "raw"),
                                n_transactions=n_transactions,
                                n_customers=n_customers,
                                n_articles=n_articles,
                                n_product_types=N_PRODUCT_TYPES, seed=seed)
    generate_s = time.perf_counter() - t0

    # --- the three front stages in memory, then streamed -------------------
    settings = pipeline_settings(raw, workdir / "memory")
    memory_s = run_front_stages(settings)
    rss_memory = peak_rss_gb()
    front_modules = sorted(m for m in sys.modules
                           if m.split(".")[0] in ("pandas", "pyarrow"))
    require(not front_modules, f"the front stages imported {front_modules}")
    date = settings.date_column
    rows = {split: len(load_dataframe(
        getattr(settings, f"{split}_data_filepath"), columns=[date])[date])
        for split in ("train", "test")}
    for split in ("train", "test"):
        got = manifest(settings, split)["num_rows"]
        require(got == rows[split],
                f"{split} manifest holds {got} rows, the split {rows[split]}")
    split_articles = [load_dataframe(
        getattr(settings, f"{split}_data_filepath"),
        columns=[settings.article_id_column])[settings.article_id_column]
        for split in ("train", "test")]
    seen = len(np.unique(np.concatenate(split_articles)))
    rows["candidates"] = manifest(settings, "candidates")["num_rows"]
    require(rows["candidates"] == seen,
            f"{rows['candidates']} candidate rows for {seen} articles seen")
    schema = Schema.load(settings.schema_dirpath)
    present = schema.logq[1:][schema.logq[1:] != 0]
    logq_sum = float(np.exp(present.astype(np.float64)).sum())
    require(abs(logq_sum - 1.0) <= 1e-5, f"exp(logQ) sums to {logq_sum}")
    digests, shard_bytes = shard_digests(settings)

    n_rows = sum(1 for _ in open(raw["transactions"])) - 1
    quarter = -(-n_rows // 4)
    streamed = pipeline_settings(raw, workdir / "streamed",
                                 etl_chunk_rows=quarter,
                                 schema_stream_rows=quarter,
                                 shard_stream_rows=quarter)
    streamed_s = run_front_stages(streamed)
    rss_streamed = peak_rss_gb()
    front_modules = sorted(m for m in sys.modules
                           if m.split(".")[0] in ("pandas", "pyarrow"))
    require(not front_modules, f"the front stages imported {front_modules}")
    got, _ = shard_digests(streamed)
    require(got == digests,
            f"{sum(got.get(k) != v for k, v in digests.items())} of "
            f"{len(digests)} shard arrays differ between the streamed and "
            f"the in-memory runs (or the files differ: "
            f"{sorted(set(got) ^ set(digests))[:4]})")
    other = Schema.load(streamed.schema_dirpath)
    for fa, fb in zip(schema.features, other.features):
        require(fa.name == fb.name and (not fa.has_vocab
                                        or np.array_equal(fa.vocab, fb.vocab)),
                f"the streamed vocab of {fa.name} differs")
    require(np.array_equal(schema.logq, other.logq),
            "the streamed logQ differs")
    stats = {f.name: {"memory": [f.mean, f.std],
                      "streamed": [g.mean, g.std]}
             for f, g in zip(schema.features, other.features) if f.standardize}
    shutil.rmtree(workdir / "streamed")

    # --- the modelling stage and the baseline, counts from 0 ---------------
    sync(dev)
    bt.reset_launches()
    qt.reset_launches()
    t0 = time.perf_counter()
    results = modelling_runner(settings, device=dev)
    sync(dev)
    modelling_s = time.perf_counter() - t0
    launches = {**bt.LAUNCHES, **qt.LAUNCHES}
    # --------------------------------------------------------------------
    for name in ("initial", "final"):
        check_runner_recall(name, results[name], schema.model_config.ks)
    require(results["final"][100] > results["initial"][100],
            f"recall@100 did not rise: {results}")
    require(dev.type != "cuda" or (launches["bin_max2_first_round"] > 0
                                   and launches["bin_max2_round"] > 0),
            f"evaluate did not launch kernels 1-2: {launches}")
    require(all(v == 0 for k, v in launches.items()
                if k not in ("bin_max2_first_round", "bin_max2_round")),
            f"the runner launched other kernels: {launches}")
    t0 = time.perf_counter()
    baseline = baseline_modelling_runner(settings, device=dev)
    sync(dev)
    baseline_s = time.perf_counter() - t0
    check_runner_recall("baseline", baseline, schema.model_config.ks)
    emit({"pipeline": {
        "transactions": n_rows, "customers": n_customers,
        "articles": n_articles, "history": HISTORY_LEN,
        "train_batch": PIPELINE_TRAIN_B,
        "generate_s": generate_s,
        "stage_s": {"memory": memory_s, "streamed": streamed_s},
        "stream_rows": quarter,
        "rows": rows,
        "vocab_sizes": {f.name: len(f.vocab) for f in schema.features
                        if f.has_vocab and not f.shared_vocab_with},
        "shard_arrays": len(digests), "shard_bytes": shard_bytes,
        "streamed_shards_bitwise": True, "streamed_vocabs_and_logq_equal": True,
        "numeric_stats": stats, "logq_exp_sum": logq_sum,
        "peak_rss_gb": {"before": rss0, "after_memory": rss_memory,
                        "after_streamed": rss_streamed,
                        "after_modelling": peak_rss_gb()},
        "pandas_or_pyarrow_imported": False,
        "modelling_s": modelling_s, "baseline_s": baseline_s,
        "recall": {"initial": results["initial"], "final": results["final"],
                   "baseline": baseline},
        "launches": launches}})
    return launches


# --- phase 16: the rest of the host surface through the port ---------------

HOST_TRANSACTIONS = 3_000_000  # H&M's 31.8M, cut for time
HOST_SAMPLE = 0.5  # --sample: 1,500,000 transactions reach the stages
HM_WINDOW = ("2019-09-20", "2020-09-21")  # run_hm.py's train + test dates
HM_PRODUCT_TYPES, HM_GROUPS, HM_COLOURS, HM_DEPARTMENTS = 131, 19, 50, 250
TFRECORD_ROWS = 100_000  # rows a TFRecord file and a shard
CSV_CHUNK = 1 << 19  # rows a write of the transactions CSV


def hex_ids(rng, n):
    """n 64-character lowercase hex ids (H&M's customer_id format)."""
    digits = np.frombuffer(b"0123456789abcdef", np.uint8)
    raw = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    chars = digits[np.stack([raw >> 4, raw & 15], axis=-1)].reshape(n, 64)
    return chars.view("S64").reshape(n).astype(str)


def csv_fields(values):
    """A column's CSV fields: numpy's str of each value, a NaN empty."""
    values = np.asarray(values)
    out = values.astype(str)
    if values.dtype.kind == "f":
        out[np.isnan(values)] = ""
    return out.tolist()


def write_csv(path, names, chunks):
    """A CSV of plain fields: the header ``names``, then each chunk's rows
    (a chunk is a list of columns of fields)."""
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        for cols in chunks:
            f.write("\n".join(map(",".join, zip(*cols))) + "\n")


def write_hm_csvs(dirpath, n_transactions, n_customers, n_articles, seed):
    """transactions_train.csv, articles.csv and customers.csv with the file
    names, columns and date window that ``examples/run_hm.py`` reads (the
    column sets of ``benchmarks/synthesize_hm_scale.py``, written with
    numpy): article ids as H&M's zero-padded 10 digits, 64-hex customer
    ids, FN 1.0 or missing, ages with 1% missing, Zipf customers and
    articles, 60% of purchases from the customer's two favourite product
    types, dates uniform over the window. Returns the file paths."""
    rng = np.random.default_rng(seed)
    dirpath = Path(dirpath)
    dirpath.mkdir(parents=True, exist_ok=True)
    art_ids = np.unique(rng.integers(100_000_000, 1_000_000_000,
                                     2 * n_articles))
    art_ids = rng.permutation(art_ids)[:n_articles]
    art_type = rng.integers(0, HM_PRODUCT_TYPES, n_articles)
    type_group = rng.integers(0, HM_GROUPS, HM_PRODUCT_TYPES)
    article_id = np.char.zfill(art_ids.astype(str), 10)
    paths = {name: dirpath / f"{name}.csv"
             for name in ("transactions_train", "articles", "customers")}
    articles = {
        "article_id": article_id,
        "product_type_name": np.char.add("Product type ",
                                         art_type.astype(str)),
        "product_group_name": np.char.add(
            "Garment group ", type_group[art_type].astype(str)),
        "colour_group_name": np.char.add(
            "Colour ", rng.integers(0, HM_COLOURS, n_articles).astype(str)),
        "department_name": np.char.add(
            "Department ",
            rng.integers(0, HM_DEPARTMENTS, n_articles).astype(str)),
    }
    write_csv(paths["articles"], articles,
              [list(map(csv_fields, articles.values()))])
    cust_ids = hex_ids(rng, n_customers)
    age = rng.integers(16, 100, n_customers).astype(np.float64)
    age[rng.random(n_customers) < 0.01] = np.nan
    customers = {
        "customer_id": cust_ids,
        "FN": np.where(rng.random(n_customers) < 0.35, 1.0, np.nan),
        "age": age,
    }
    write_csv(paths["customers"], customers,
              [list(map(csv_fields, customers.values()))])

    def zipf(n, s):
        p = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
        return p / p.sum()

    art_p = zipf(n_articles, 1.05)
    cust_idx = rng.choice(n_customers, n_transactions, p=zipf(n_customers,
                                                              0.7))
    art_idx = rng.choice(n_articles, n_transactions, p=art_p)
    fav = rng.integers(0, HM_PRODUCT_TYPES, (n_customers, 2))
    rows = np.flatnonzero(rng.random(n_transactions) < 0.6)
    target = fav[cust_idx[rows], rng.integers(0, 2, len(rows))]
    # an inverse-CDF draw inside the favourite type's slice of articles
    order = np.argsort(art_type, kind="stable")
    bounds = np.searchsorted(art_type[order], np.arange(HM_PRODUCT_TYPES + 1))
    cum = np.concatenate(([0.0], np.cumsum(art_p[order])))
    lo, hi = bounds[target], bounds[target + 1]
    u = cum[lo] + rng.random(len(rows)) * (cum[hi] - cum[lo])
    art_idx[rows] = order[np.clip(np.searchsorted(cum, u, side="right") - 1,
                                  lo, np.maximum(hi - 1, lo))]
    start, end = (np.datetime64(d, "D") for d in HM_WINDOW)
    days = (start + np.arange((end - start).astype(int) + 1)).astype(str)
    day = rng.integers(0, len(days), n_transactions)
    price = np.round(np.exp(rng.normal(-3.6, 0.7, n_transactions)), 6)
    channel = rng.integers(1, 3, n_transactions)
    # the distinct values' fields once, each row indexing them
    day_f, cust_f, art_f = map(csv_fields, (days, cust_ids, article_id))
    price_f, channel_f = csv_fields(price), csv_fields(channel)

    def chunks():
        for a in range(0, n_transactions, CSV_CHUNK):
            b = slice(a, a + CSV_CHUNK)
            yield [list(map(f.__getitem__, idx[b].tolist())) for f, idx in (
                (day_f, day), (cust_f, cust_idx), (art_f, art_idx))] + [
                    price_f[b], channel_f[b]]

    write_csv(paths["transactions_train"],
              ["t_dat", "customer_id", "article_id", "price",
               "sales_channel_id"], chunks())
    return {k: str(v) for k, v in paths.items()}


def run_hm_example():
    """``examples/run_hm_torch.py`` as a module, for in-process calls."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "run_hm_torch", ROOT / "examples" / "run_hm_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def shard_arrays(dirpath):
    from hm_retrieval_tpu_torch.data.dataset import ShardDataset

    ds = ShardDataset(str(dirpath))
    return ds.manifest, ds.load_all()


def packed_windows(ids):
    """Sequence windows with their id-0 cells (pads and OOV tokens) taken
    out, the rest moved left: what an exported window reads back as."""
    keep = ids != 0
    out = np.zeros_like(ids)
    rows, cols = np.nonzero(keep)
    out[rows, (np.cumsum(keep, axis=1) - 1)[rows, cols]] = ids[rows, cols]
    return out


def same_shards(a, b, what, expect=None):
    """The shards at ``a`` equal those at ``b``, with ``expect[name]``
    applied to ``b``'s array of that name first."""
    (ma, da), (mb, db) = shard_arrays(a), shard_arrays(b)
    for name, fn in (expect or {}).items():
        db[name] = fn(db[name])
    require(ma == mb, f"{what}: the manifests differ: {ma} / {mb}")
    require(sorted(p.name for p in Path(a).glob("shard_*.npz"))
            == sorted(p.name for p in Path(b).glob("shard_*.npz")),
            f"{what}: other shard files")
    bad = [k for k in da if da[k].dtype != db[k].dtype
           or not np.array_equal(da[k], db[k], equal_nan=True)]
    require(set(da) == set(db) and not bad, f"{what}: arrays differ: {bad}")


def phase_tfrecords(settings, workdir):
    """(a)'s test split through ``dataframe_to_tfrecords`` and
    ``import_tfrecords``, held array for array against a direct
    ``ShardWriter`` write of the same table; then
    ``export_shards_to_tfrecords`` and a second import, equal again: the
    exported values are the shards' standardized numerics, so the second
    import does not standardize again, and an export drops a window's id-0
    cells, an OOV token's too, so its windows read back packed
    (``packed_windows``), in both packages. Returns the readings."""
    from hm_retrieval_tpu_torch.data import tfrecord_compat as tfc
    from hm_retrieval_tpu_torch.data.shard_writer import ShardWriter
    from hm_retrieval_tpu_torch.etl.transformations import (
        load_dataframe, table_len,
    )
    from hm_retrieval_tpu_torch.schema import Schema

    features = Schema.load(settings.schema_dirpath).features
    table = load_dataframe(settings.test_data_filepath,
                           columns=[f.name for f in features])
    rows = table_len(table)
    ShardWriter(features, TFRECORD_ROWS).write_shards(
        table, str(workdir / "direct"))
    t0 = time.perf_counter()
    paths = tfc.dataframe_to_tfrecords(table, features,
                                       str(workdir / "tfr" / "test"),
                                       max_rows=TFRECORD_ROWS)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tfc.import_tfrecords(str(workdir / "tfr"), features,
                         str(workdir / "imported"), max_rows=TFRECORD_ROWS)
    import_s = time.perf_counter() - t0
    same_shards(workdir / "imported", workdir / "direct",
                "TFRecord import against the direct write")
    t0 = time.perf_counter()
    exported = tfc.export_shards_to_tfrecords(
        str(workdir / "direct"), features, str(workdir / "out" / "test"),
        max_rows=TFRECORD_ROWS)
    export_s = time.perf_counter() - t0
    # the shards hold standardized numerics: read them back as they are
    as_stored = [dataclasses.replace(f, standardize=False) for f in features]
    tfc.import_tfrecords(str(workdir / "out"), as_stored,
                         str(workdir / "reimported"), max_rows=TFRECORD_ROWS)
    same_shards(workdir / "reimported", workdir / "direct",
                "export, then import, against the direct write",
                expect={f.name: packed_windows for f in features
                        if f.kind == "sequence"})
    # the CRC alone, over every record of the written files at once
    payloads = [r for p in paths for r in tfc.iter_tfrecords(p, False)]
    lengths = np.fromiter(map(len, payloads), np.int64, count=len(payloads))
    blob = np.frombuffer(b"".join(payloads), np.uint8)
    t0 = time.perf_counter()
    tfc._masked_crcs(blob, np.cumsum(lengths) - lengths, lengths)
    crc_s = time.perf_counter() - t0
    nbytes = sum(Path(p).stat().st_size for p in paths)
    return {"rows": rows, "files": len(paths), "bytes": nbytes,
            "export_bytes": sum(Path(p).stat().st_size for p in exported),
            "write_s": write_s, "import_s": import_s, "export_s": export_s,
            "write_records_per_s": rows / write_s,
            "import_records_per_s": rows / import_s,
            "crc_s": crc_s, "crc_mb_per_s": len(blob) / crc_s / 1e6,
            "import_equals_direct_write": True,
            "export_reimport_equals": True}


def phase_debug_checks(settings, dev):
    """Under ``enable_debug_checks`` a NaN made on the card in forward and
    one made only in backward (autograd's device thread) raise; one sparse
    training step at B = 512 and ``exact_topk`` at B = 128 over the trained
    catalog run clean and give the bits they give without the checks; after
    ``disable_debug_checks`` the NaN passes silently. Returns the
    readings."""
    from hm_retrieval_tpu_torch.data.dataset import ShardDataset
    from hm_retrieval_tpu_torch.data.device_feed import device_feed
    from hm_retrieval_tpu_torch.indices import load_index
    from hm_retrieval_tpu_torch.models import (
        TwoTowerModel, make_single_device_trainer, train_state_to_numpy,
    )
    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.schema import Schema
    from hm_retrieval_tpu_torch.utils.debugging import (
        disable_debug_checks, enable_debug_checks,
    )

    schema = Schema.load(settings.schema_dirpath)
    batch = next(iter(ShardDataset(settings.train_shards_dirpath)
                      .iter_batches(schema.training_config.train_batch_size)))
    index = load_index(settings.index_dirpath, device=dev)
    gen = torch.Generator(device=dev).manual_seed(16)
    q = torch.randn(128, E, device=dev, generator=gen)
    catalog = index.embeddings[:index.num_candidates]

    def step_and_topk():
        model = TwoTowerModel.create_from_schema(schema, device=dev)
        state, step = make_single_device_trainer(model,
                                                 schema.training_config)
        state, metrics = step(state, next(device_feed([batch], device=dev)))
        v, i, rounds = bt.exact_topk(q, catalog, SERVE_K)
        sync(dev)
        return (flatten_tree(train_state_to_numpy(state)),
                float(metrics["loss"]), v.cpu(), i.cpu())

    def raised(fn):
        try:
            fn()
            sync(dev)
        except FloatingPointError as exc:
            return str(exc)
        return None

    def forward_nan():
        return torch.ones(4, device=dev) / 0.0 * 0.0

    def backward_nan():
        x = torch.tensor([0.0, 1.0], device=dev, requires_grad=True)
        torch.where(x > 0, torch.log(x), 0.0).sum().backward()

    plain = step_and_topk()
    enable_debug_checks()
    try:
        t0 = time.perf_counter()
        checked = step_and_topk()
        checked_s = time.perf_counter() - t0
        forward = raised(forward_nan)
        backward = raised(backward_nan)
    finally:
        disable_debug_checks()
    require(forward is not None and "aten.mul" in forward,
            f"a NaN made in forward on the card did not raise: {forward}")
    require(backward is not None and "aten.div" in backward,
            f"a NaN made in backward on the card did not raise: {backward}")
    require(checked[1] == plain[1] and torch.equal(checked[2], plain[2])
            and torch.equal(checked[3], plain[3])
            and all(np.array_equal(a, b) for a, b in zip(checked[0],
                                                         plain[0])),
            "the step or exact_topk under the checks gave other bits")
    silent = forward_nan()
    require(bool(torch.isnan(silent).all()),
            "after disable_debug_checks the NaN did not pass")
    return {"forward_raised": forward, "backward_raised": backward,
            "clean_bits_equal": True, "checked_step_and_topk_s": checked_s,
            "nan_silent_after_disable": True}


def phase_host_surface(seed, dev, workdir, n_customers=N_CUSTOMERS,
                       n_articles=N_ARTICLES,
                       n_transactions=HOST_TRANSACTIONS):
    """Phase 16 (see the module docstring). Returns each kernel's launches
    in the three ``run_hm_torch.main`` calls, driven from 0."""
    import importlib.util

    from hm_retrieval_tpu_torch.ops import bin_topk as bt
    from hm_retrieval_tpu_torch.ops import quantized_topk as qt
    from hm_retrieval_tpu_torch.runners import CheckpointManager
    from hm_retrieval_tpu_torch.schema import Schema

    example = run_hm_example()
    t0 = time.perf_counter()
    raw = write_hm_csvs(workdir / "raw", n_transactions, n_customers,
                        n_articles, seed)
    generate_s = time.perf_counter() - t0
    w = workdir / "hm"
    base = ["--data-dir", str(workdir / "raw"), "--workdir", str(w)]
    if dev.type == "cpu":
        base += ["--device", "cpu"]
    stream = str(-(-round(HOST_SAMPLE * n_transactions) // 4))
    records = Records()
    run_log = logging.getLogger("hm_retrieval_tpu_torch.runners.modelling")
    run_log.addHandler(records)
    seconds, steps = {}, {}
    ckpt_dir = w / "artifacts" / "checkpoints"
    no_tf = importlib.util.find_spec("tensorflow") is None

    def call(name, args):
        sync(dev)
        t0 = time.perf_counter()
        out = example.main(base + args)
        sync(dev)
        seconds[name] = time.perf_counter() - t0
        return out

    def refused_export(args):
        """The call with --export-savedmodel: ImportError naming
        tensorflow, in under 5 s, no step and no checkpoint written."""
        before = (sorted(p.name for p in ckpt_dir.iterdir())
                  if ckpt_dir.exists() else [])
        t0 = time.perf_counter()
        try:
            example.main(base + args + ["--export-savedmodel"])
        except ImportError as exc:
            took = time.perf_counter() - t0
            require("tensorflow" in str(exc), f"the ImportError: {exc}")
            require(took < 5.0, f"the refused export took {took:.1f} s")
            after = (sorted(p.name for p in ckpt_dir.iterdir())
                     if ckpt_dir.exists() else [])
            require(after == before, f"checkpoints written: {after}")
            return took
        require(False, "--export-savedmodel without tensorflow ran")

    try:
        sync(dev)
        bt.reset_launches()
        qt.reset_launches()
        # (a) the front stages, sampled and streamed
        call("a_front", ["--stages", "etl,schema,shards", "--history", "16",
                         "--sample", str(HOST_SAMPLE), "--epochs", "2",
                         "--etl-chunk-rows", stream,
                         "--schema-stream-rows", stream,
                         "--shard-stream-rows", stream])
        refused = {}
        if no_tf:
            refused["b"] = refused_export(["--stages", "model,baseline",
                                           "--epochs", "1"])
        # (b) one epoch and the baseline
        results_b, baseline = call("b_model_baseline",
                                   ["--stages", "model,baseline",
                                    "--epochs", "1"])
        steps["b"] = CheckpointManager(str(ckpt_dir),
                                       device=dev).latest_step()
        launches_b = {**bt.LAUNCHES, **qt.LAUNCHES}
        if no_tf:
            refused["c"] = refused_export(["--stages", "model", "--epochs",
                                           "1", "--resume"])
        # (c) one more epoch from (b)'s checkpoint, the override logged
        records.records.clear()
        results_c, _ = call("c_resume", ["--stages", "model", "--epochs",
                                          "1", "--resume"])
        steps["c"] = CheckpointManager(str(ckpt_dir),
                                       device=dev).latest_step()
        launches = {**bt.LAUNCHES, **qt.LAUNCHES}
    finally:
        run_log.removeHandler(records)
    # ------------------------------------------------------------------
    schema = Schema.load(str(w / "schema"))
    ks = schema.model_config.ks
    for name, res in (("b initial", results_b["initial"]),
                      ("b final", results_b["final"]),
                      ("c final", results_c["final"])):
        check_runner_recall(name, res, ks)
    # a small rehearsal's popularity index may hold fewer than 1000 ids
    check_runner_recall("baseline", baseline,
                        ks if n_articles == N_ARTICLES else sorted(baseline))
    require(results_b["final"][100] > results_b["initial"][100],
            f"recall@100 did not rise in (b): {results_b}")
    require(results_c["initial"] == results_b["final"],
            f"(c) did not resume from (b): {results_c['initial']} / "
            f"{results_b['final']}")
    override = [m for m in records.records
                if "Overriding schema TrainingConfig.epochs: 2 -> 1" in m]
    require(override, "(c) did not log the epochs override")
    require(steps["c"] == 2 * steps["b"],
            f"(c) ended at step {steps['c']}, (b) at {steps['b']}: one "
            "epoch from (b)'s checkpoint ends at twice (b)'s")
    for name, got in (("b", launches_b), ("c", launches)):
        require(dev.type != "cuda" or (got["bin_max2_first_round"] > 0
                                       and got["bin_max2_round"] > 0),
                f"evaluate did not launch kernels 1-2 by ({name}): {got}")
    require(all(v == 0 for k, v in launches.items()
                if k not in ("bin_max2_first_round", "bin_max2_round")),
            f"the runs launched other kernels: {launches}")
    args, _ = example.parse_args(base)
    settings = example.make_settings(args, raw["transactions_train"])
    t0 = time.perf_counter()
    tfrecords = phase_tfrecords(settings, workdir / "tfrecords")
    tfrecord_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    debug = phase_debug_checks(settings, dev)
    debug_s = time.perf_counter() - t0
    emit({"host_surface": {
        "transactions": n_transactions, "sample": HOST_SAMPLE,
        "customers": n_customers, "articles": n_articles,
        "generate_s": generate_s, "calls_s": seconds,
        "stream_rows": int(stream), "steps": steps,
        "recall": {"b_initial": results_b["initial"],
                   "b_final": results_b["final"],
                   "c_final": results_c["final"], "baseline": baseline},
        "epochs_override_logged": True,
        "export_refused_s": refused if no_tf else "tensorflow present",
        "tfrecord": tfrecords, "tfrecord_s": tfrecord_s,
        "debug": debug, "debug_s": debug_s,
        "vocab_sizes": {f.name: len(f.vocab) for f in schema.features
                        if f.has_vocab and not f.shared_vocab_with},
        "launches": launches}})
    return launches


@contextlib.contextmanager
def checkpoint_times():
    """Inside the block, ms of each ``CheckpointManager`` host copy
    (``save``), background write and ``restore``, synchronised."""
    from hm_retrieval_tpu_torch.runners.checkpoint import CheckpointManager

    ms = {"copy": [], "write": [], "restore": []}
    fns = {"copy": CheckpointManager.save, "write": CheckpointManager._write,
           "restore": CheckpointManager.restore}

    def timed(kind):
        def run(self, *args, **kwargs):
            sync(self.device)
            t0 = time.perf_counter()
            out = fns[kind](self, *args, **kwargs)
            sync(self.device)
            ms[kind].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    with swapped(CheckpointManager, save=timed("copy"), _write=timed("write"),
                 restore=timed("restore")):
        yield ms


def flatten_tree(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten_tree(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in flatten_tree(v)]
    return [tree]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--repeats", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import hm_retrieval_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable: {exc}", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    seconds = {}
    t_phase = time.perf_counter()

    def lap(name):
        nonlocal t_phase
        now = time.perf_counter()
        seconds[name] = now - t_phase
        t_phase = now

    card = phase_device()
    lap("1_device")
    stats = phase_kernels(gen, dev)
    lap("2_kernels")
    build_root = ROOT / "build"
    build_root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root, prefix="chip_smoke-") as d:
        launches, shared = phase_serving(args.seed, args.repeats, dev, Path(d))
        lap("3_serving")
        stats.update(phase_quantized_kernels(gen, dev))
        lap("4_quantized_kernels")
        quantized, recalls = phase_quantized_serving(shared, args.repeats, dev,
                                                     Path(d))
        launches.update(quantized)
        lap("5_quantized_serving")
        rounds_stats = phase_rounds_kernels(gen, dev)
        # kernel 8's errors over phase 2's shapes and phase 6's
        k8, k8_phase2 = rounds_stats["bin_max_round"], stats["bin_max_round"]
        k8["max_abs_err"] = max(k8["max_abs_err"], k8_phase2["max_abs_err"])
        k8["id_mismatches"] += k8_phase2["id_mismatches"]
        stats.update(rounds_stats)
        launches["bin_max_round"] = phase_rounds_drivers(gen, dev)[
            "bin_max_round"]
        lap("6_rounds_kernels")
        rounds = phase_rounds_serving(shared, recalls, args.repeats, dev,
                                      Path(d))
        for name in ROUNDS_KERNELS:
            launches[name] = rounds[name]
        lap("7_rounds_serving")
    phase_widths(args.seed, dev)
    lap("8_widths")
    with tempfile.TemporaryDirectory(dir=build_root,
                                     prefix="chip_smoke-train-") as d:
        phase_training(args.seed, dev, Path(d))
    lap("9_training")
    with tempfile.TemporaryDirectory(dir=build_root,
                                     prefix="chip_smoke-runner-") as d:
        # phases 10 and 12's launches are added to each kernel's count
        runner_launches, ctx = phase_runner(args.seed, dev, Path(d))
        for name, n in runner_launches.items():
            launches[name] += n
        lap("10_runner")
        phase_baseline(ctx, dev)
        lap("11_baseline")
        for name, n in phase_sharded(ctx, args.repeats, dev, Path(d)).items():
            launches[name] += n
        lap("12_sharded")
        # phase 13: training over a mesh; (c)'s launches join the count
        mesh_rows = phase_mesh_training(args.seed, dev)
        for name, n in phase_mesh_runner(ctx, dev, Path(d)).items():
            launches[name] += n
        lap("13_mesh_training")
        # phase 14: two ranks on the card; both ranks' launches join
        for name, n in phase_processes(ctx, args.seed, args.repeats, dev,
                                       Path(d), mesh_rows).items():
            launches[name] += n
        lap("14_processes")
        # phase 17: one process over the card and the host (and over every
        # card where there are several), on phase 10's data; (b) and (c)'s
        # launches join
        for name, n in phase_several_devices(ctx, args.seed, dev,
                                             Path(d)).items():
            launches[name] += n
        lap("17_several_devices")
        # phase 18: two ranks of a group, each over the card and the host
        # CPU (and over two cards each where there are four), on phase 10's
        # data; both ranks' (b) and (c) launches join
        for name, n in phase_ranks_several_devices(ctx, args.seed,
                                                   args.repeats, dev,
                                                   Path(d)).items():
            launches[name] += n
        lap("18_ranks_several_devices")
        del ctx
    with tempfile.TemporaryDirectory(dir=build_root,
                                     prefix="chip_smoke-pipeline-") as d:
        # phase 15: the five stages through the port alone
        for name, n in phase_pipeline(args.seed, dev, Path(d)).items():
            launches[name] += n
    lap("15_pipeline")
    with tempfile.TemporaryDirectory(dir=build_root,
                                     prefix="chip_smoke-host-") as d:
        # phase 16: run_hm_torch.py's calls, TFRecords, the NaN checks
        for name, n in phase_host_surface(args.seed, dev, Path(d)).items():
            launches[name] += n
    lap("16_host_surface")
    emit({"phase_seconds": seconds})

    pallas = "hm_retrieval_tpu/ops/pallas_retrieval.py"
    kernel_files = {
        "bin_max2_first_round": ("bin_max2.cu", 276),
        "bin_max2_round": ("bin_max2.cu", 207),
        "bin_max2_scaled_single_pass": ("bin_max2.cu", 352),
        "bin_max2_scaled_fold_pass": ("bin_max2.cu", 464),
        "bin_max2_raw_fold_pass": ("bin_max2.cu", 593),
        "bin_max2_scaled_first_round": ("bin_max2.cu", 311),
        "bin_max2_scaled_round": ("bin_max2.cu", 701),
        "bin_max_round": ("bin_max2.cu", 158),
    }
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": f"hm_retrieval_tpu_torch/csrc/{kernel_files[name][0]}",
            "replaces": f"{pallas}:{kernel_files[name][1]}",
            "launches": launches[name],
            **st,  # max_abs_err, id_mismatches, ms, plain_ms, bound_ms, ...
            "library_ms": None,
        }
        for name, st in stats.items()
    ]
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
