"""Drive the PyTorch/CUDA port on one GPU: build its kernels, hold each
against its plain version, check the 8B and Mixtral models and their
decode and prefill graphs (legacy and paged KV), serve both (streamed,
observed through the cell's metrics, traces, timers and profiler, agent
sessions through the prefix cache, the paged KV cache, and the KV
handoff between a prefill and a decode cell), boot llama3-8b from a
checkpoint streamed onto the card while its programs are captured, sweep
two decode chunks into a tuning profile that a cell boots from, profile
that cell layer by layer, serve llama3-8b through the tensor-parallel
code over a one-rank NCCL group and hold the kernels at every shard shape
of 2, 4 and 8 ranks, serve llama3-1b from the checkpoints the port
writes and reads itself (HF, kukeon int8, and orbax, with the port's own
zstd decoder), serve bge-base embeddings, also from orbax, serve
Mixtral-8x7B and bge-base through the tensor-parallel code over a one-rank
NCCL group and hold the kernels at every Mixtral shard shape of 2, 4 and 8
ranks, train Llama and Mixtral, saving and resuming through orbax, run the
sequence-parallel attention bodies and the pipeline step, hold a Mixtral
MoE layer's dispatch on seq meshes to one device's, and grant a GPU
through the port's device manager.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases card,moe_kernel   # a subset; no result line

Phases, in the order they run, each printing one JSON line with its wall
time; any failure ends the run with a nonzero exit and no result line:

  card        nvidia-smi name and power limit, versions, and the build of
              both CUDA sources (csrc/int8_matmul.cu, csrc/flash_attention.cu),
              one nvcc each, started together, and of the checkpoint
              reader's host library (csrc/zstd_decode.cpp, the host C++
              compiler) beside them; ptxas registers, shared
              memory and spills for every kernel; the count of HGMMA (wgmma)
              and HMMA (mma.sync) instructions in each kernel's SASS
              (cuobjdump), which shows the tensor-core path was compiled in
  kernel      int8_matmul vs int8_matmul_reference at every llama3-8b decode
              shape, and transposed (q [N,K]) at the llama3-1b tied head and
              at (K, N) (4096, 4096), (4096, 1024) and (14336, 4096), B in
              {1, 3, 4, 16, 64}; f32 h (the first design's kernels) at
              4096 x 4096, B 4, and transposed at the tied head, every B;
              at B = 4: kernel, plain and library times
              (CUDA events, median of 20 cold-L2 runs) beside the bound, and
              the kernel's device time by projection (torch.profiler, cold
              L2; the three extra transposed shapes: device time only); one
              bf16 call is one kernel launch (profiler), and a second call
              at every 8B shape and at the tied head, B 4 and 64, is
              bit-identical
  flash       flash_attention vs flash_attention_reference: llama3-1b
              training heads (B 4, S 2048, H 32, KV 8, D 64), Mixtral's
              training heads (B 2, S 2048, H 32, KV 8, D 128), llama3-8b
              heads (B 1, S 1024, D 128), offset positions, KV = H, a ragged
              S (160), and an f32 case; at both training shapes: kernel,
              plain and library (scaled_dot_product_attention) times beside
              the bound, the kernels' device time (torch.profiler), and the
              shares of the bf16 peak; then S 8192 (B 1, H 8, KV 2, D 64)
              in full and S 65792 (B 1, H 1, D 64, kv-tile lists past
              shared memory) on three 256-row query slices against all keys
  moe_kernel  int8_matmul_expert vs int8_matmul_expert_reference at both
              Mixtral-8x7B expert shapes (E 8; K x N 4096 x 14336 and
              14336 x 4096), C in {1, 3, 4, 16, 64}, and an f32 case; at
              C = 4: kernel, plain and library times beside the bound with
              every expert's rows filled, and with the rows of a decode step
              (4 tokens routed top-2 of 8 from a seed: the experts no token
              chose keep zero rows, their outputs must be exactly +0, and
              the bound counts only the weights of the experts in use); the
              device time of the kernel and of its reduce launch
  model       llama3-8b int8 on the card: one prefill and one decode step
              through the kernel and through the dequant product; logits
              agree; the step makes 225 kernel launches
  serve       the port's ServingCell("llama3-8b", dtype="int8", 4 slots,
              max_seq_len 1024) over HTTP, its warmup capturing the decode
              graphs and the 128 bucket's prefill graph (precompile: capture
              s, pool bytes, and the prefill programs' static bytes): 4
              concurrent 128-token prompts, 64 greedy tokens each, a repeat
              for determinism, /readyz; then torch.profiler over 4 more HTTP
              requests: device busy share, top kernels and host operators,
              and the launches inside the graph replays (K1 225 a decode
              step, one cudaGraphLaunch a chunk and one a prefill); no
              capture after warmup; then one streamed request with a stop
              string (the 24th token's text, under a tokenizer that shows
              every id): the records' joined text equals the non-streamed
              answer cut there, the terminal record says stopped, and
              every slot is free again
  serve_obs   the cell's instruments on serve's cell (no new draw): serve's
              prompts with a traceparent each, 32 tokens, plus one
              stochastic request whose keys are captured at first use, while
              a thread scrapes /metrics every 10 ms and the CUDA runtime
              probe runs; then the greedy prompts under torch.profiler.
              Every scrape parses; request, token and TTFT-count deltas
              equal what was sent; kukeon_compiles_total moves by the
              stochastic keys' captures alone; the decode dispatch counter
              by the replays the profiler saw; the program seconds cover
              the profiled device time; the decode bandwidth gauge within
              20% of the bound over the timers' ms a step, below 1; the
              peak-memory gauge equals max_memory_allocated; each span's
              events submitted..finished and the timeline's trace ids; a
              POST /v1/profile capture on disk; the probe answers ok; each
              key captured mid-traffic replays bitwise as it runs eagerly.
              Prints the scrape ms under traffic and the probe's seconds
  serve_stream  serve's llama3-8b int8 tree (serve's cell, kept) saved as a
              kukeon int8 checkpoint (~8 GB) into a temporary directory
              (its free space printed first), then a ServingCell booted
              with checkpoint=dir: reader threads stream the leaves, the
              engine's load thread copies them onto the card, its warmup
              captures meanwhile; serve's traffic through it must give
              serve's greedy tokens with 225 K1 a step in its profiled
              replays, and kukeon_checkpoint_load_bytes_total must equal
              the tree's leaf bytes. Reports the save, construction to
              ready, the load's disk/cast/upload seconds, the engine's boot
              marks and the share of the load the captures overlapped (a
              report: it depends on the disk). Then (b) the same cell at
              chips=1, a one-rank NCCL group whose rank streams its blocks
              (a "stream" recipe), with the same gates and reports; and (c)
              the rank readers at t = 2, 4 and 8 on the same directory,
              the ranks of a t at once, each in a process of its own
              (forked from a fork server that has only imported the
              readers) without a group, its leaves copied onto the card: every leaf's shape,
              dtype and two exact integer sums equal those of the block of
              serve's tree, summed on the card leaf by leaf; per rank its
              seconds, the bytes it requested from disk, its blocks' bytes,
              the most a reader job declared at once (job_peak_bytes, a
              count of its own buffers) and its process's resident-set
              growth over its baseline (VmRSS from /proc/self/status,
              sampled every 5 ms). The directory is removed
  serve_tune  the tuning profile and the layer profile on serve's weights:
              tools/autotune.py's sweep over two arms (decode chunk 16
              and 64, each a cell over serve's weights with serve's
              traffic, tokens equal to serve's), the winner saved with
              tuning.save into this run's profile file (KUKEON_TUNE_PATH
              and KUKEON_LAYER_PROFILE_PATH point into a temporary
              directory for the whole run); a cell built with every lever
              None takes the winner's levers and gives serve's tokens; POST
              /v1/profile {"layers": true} on it persists a 34-component
              profile without error. Reports each arm, the layers' decode
              times and their sum beside the cell's ms a step (HTTP) and a
              16-step replay timed alone. The profile file is removed, so
              later phases boot untuned
  serve_tp    tensor-parallel serving on the one card: (a) K1 at every
              llama3-8b projection's per-rank shard shape and K1t at the
              llama3-1b head's, for t = 2, 4 and 8, B 4 (a head's
              vocabulary shard padded to 128-wide tiles, as the port pads
              it), against the plain version (the kernel phase's
              tolerance), with the route each call took (the kernel), the
              kernel's and the plain version's cold-L2 ms and device ms, and
              one rank's K1 sum for an 8B decode step beside its bytes
              bound; (b) ServingCell("llama3-8b", dtype="int8",
              chips=1) drawn from serve's seed, through serve_model: a
              one-rank NCCL group, the
              forward's collectives inside the captured graphs, serve's
              greedy tokens bitwise, 225 K1 and 0 K1t a step, its ms a step
              and tok/s beside serve's; then, on that cell, POST
              /v1/profile {"layers": true} through the group path: 34
              components, no error, under llama3-8b|gpu|1, each
              component's FLOPs and bytes those of serve_tune's one-device
              profile (or, when serve_tune did not run, of layer_cost's),
              K1 launched by its int8 components (the launch counter, zeroed
              just before); (c) the runner's command line with
              --chips 2 on the one card (started beside (a)) exits non-zero
              with the over-grant message, and in this process the grant is
              refused with no byte allocated. Times only: nothing here spans two GPUs
  serve_tied  a short llama3-1b run, whose tied LM head takes the
              transposed kernel (K1t 1 and K1 112 a step)
  serve_ckpt  serving from checkpoints: a llama3-1b HF checkpoint at full
              width and depth (1.24 B parameters, tied head, f16, ~2.5 GB
              over 1 GiB shards with an index) written into a temporary
              directory by the port's synthesize_hf_checkpoint (tokenizer.json
              only where the tokenizers package imports; which of
              safetensors, tokenizers and ml_dtypes import is printed first,
              and none is used). Gates: (a) load_params_quantized equals
              llama.quantize_params of the f32 load_params computed on the
              card, q and s bit for bit; (b) save_quantized then
              load_quantized gives the same leaves bit for bit; (c) a cell
              booted with checkpoint=dir and dtype int8 (serve_tied's
              traffic through serve_model: K1 112 and K1t 1 a decode step in
              its profiled replays), a cell booted from the quantized
              directory and an engine over (a)'s card-side tree give the
              same greedy tokens; (d) a bf16 cell booted from the directory
              gives the tokens of an engine over load_params of it in
              memory; after (b), the rank readers of the HF directory under
              int8 at t = 2 and 8, as serve_stream's (c), each block
              against (a)'s host tree (a row-parallel leaf's scale from its
              whole rows; the tied head's shard tile-padded). The three
              cells boot through the stream: each one's
              load-bytes counter must equal its leaf bytes; then the same
              three booted on the trees the materialized loaders gave
              above (the whole tree in host memory first) must give the
              same tokens. Seconds to write, load and save, bytes on disk,
              each cell's seconds from construction to ready (streamed;
              materialized: the loader's seconds plus the cell's) and each
              streamed boot's stages and marks; the directory is removed
              at the end
  serve_orbax  orbax checkpoints, read and written by the port's own code:
              (a) the fixture the JAX package wrote (tests/data/
              orbax_llama_tiny: zarr chunks in zstd level-1 frames in an
              OCDBT store) decoded on this host by the decoder built here,
              every leaf's sha256 equal to tests/data/orbax_llama_tiny.json;
              (b) llama3-1b at full width and depth, bf16, drawn on the card
              and written with orbax_ckpt.write_tree into a temporary
              directory; a cell booted from it with dtype int8 takes
              serve_tied's traffic through serve_model (K1 112 and K1t 1 a
              decode step in its profiled replays) and gives the tokens of an
              engine over quantize_params of the same weights in memory, and
              a bf16 cell those of an engine over the bf16 weights; each
              cell's kukeon_checkpoint_load_bytes_total equals the leaf bytes
              written; (c) bge-base, bf16, a cell's weights written the same
              way and an EmbeddingCell booted from them: its /v1/embed vectors
              equal, bit for bit, those of the cell the weights came from.
              Reports the bytes on disk, the write, the load's disk, decode
              and upload seconds and each cell's seconds to ready; the
              directory is removed at the end
  serve_tiny  short int8 runs of tiny and mixtral-tiny, whose dims off 128
              take the reference's dequant fallback on the card
  moe_model   mixtral-8x7b int8 at full width and depth, drawn once on the
              card by the serving cell of serve_moe: one prefill (B 4,
              S 128) and one decode step through the kernels and through
              the dequant products; the step makes 129 int8_matmul and 96
              int8_matmul_expert launches; logits agree on rows routed
              alike, and a routing flip happens only on a near tie
  graph_decode  llama3-8b (drawn here) and that mixtral-8x7b, 4 slots
              decoding 128-token prompts: the engine state is saved, a
              4-step program replays, the state is put back and the same
              program runs op by op; tokens, lengths and the KV rows
              written are bitwise equal, greedy and for a stochastic key
              (temperature, top-k and top-p) from the same generator state;
              then a 16-step replay timed: host ms of the replay call, CUDA
              events around it, and its kernels' device ms (profiler)
  graph_prefill  the same two models: a prefill program (prefill, first
              token's sample and insert, one graph) replayed and run op by
              op from one saved state, at bucket 128 greedy and with a
              stochastic key, and a prefill_ext at (Pb 512, S_tail 64)
              over a stored 400-token prefix; first token, the slot's K/V
              rows, length, token, active, the KV block and the generator
              state bitwise equal; a prefix hit's first-token logits
              against a full prefill of the same prompt (logits_agree)
  graph_paged  llama3-8b (the graph phases' draw) behind a paged engine
              (kv_page_tokens 64, 4 slots, max_seq_len 1024), bf16 KV and
              int8 KV: a paged prefill program at bucket 128 (greedy; bf16
              KV also stochastic) and a prefill_ext_paged over the shared
              pages of a stored 400-token prefix (Pb 512, S 128), then the
              4-step paged decode program (greedy; bf16 KV also
              stochastic), each replayed and run op by op from one saved
              state: tokens, lengths, active, the block table, the pool
              rows written (page 0, scratch, aside), the KV block and the
              generator state bitwise equal; a 16-step replay timed; the
              dense view's and the pools' bytes
  serve_moe   that ServingCell over HTTP: 4 concurrent 128-token prompts,
              32 greedy tokens each, a repeat, /readyz, a profiled window
              (K1 129 and K2 96 a decode step inside the replays); then a
              second engine on the same weights with the paged KV cache
              (pages of 64): the same tokens, the same launches a step;
              both engines' 16-step decode program replayed in turns
              (legacy, paged, paged, legacy); then one KV handoff: the
              legacy engine exports the first prompt, the paged engine
              imports it, and its greedy tokens are the legacy cell's
  serve_prefix  llama3-8b int8, 4 slots, max_seq_len 1024, over HTTP: four
              agent sessions (prefixId sess-0..3), six turns each, 384
              tokens the first and each later turn the previous prompt, its
              32 generated tokens and a 32-token user message; the same
              prompts again without prefixId (the control); TTFT per turn
              and arm, 20 hits and 4 misses, no capture in the measured
              traffic, hit tokens against the control's
  serve_paged  llama3-8b int8, max_seq_len 1024, pages of 64 rows: (a) a
              ServingCell with kv_page_tokens 64 over HTTP takes serve's
              traffic: its greedy tokens equal serve's, 225 K1 a step
              inside the replays, no capture in the traffic; (b) the
              reference's paged arm (bench.py:340-400) through the engine:
              24 requests on one 256-token prefix ("agent"), tails of 32
              and 384 tokens, 64 and 128 greedy tokens, at 4 slots on the
              legacy layout and at 12 and 16 slots on a 64-page pool (the
              legacy arm's rows); each arm runs the traffic once to capture
              its keys, then measured: every request complete, the same
              tokens both times, no capture, the 16-slot arm preempting;
              tokens/s, TTFT p50/p95, ms a step, hits, preemptions, peak
              pages in use, pool and view bytes
  serve_disagg  the KV handoff, both hops driven as the reference's
              gateway drives them (/v1/kv/export, then /v1/kv/import):
              (a) llama3-8b int8 drawn again from serve's seed, a legacy
              prefill cell and two decode cells (legacy, and paged with
              pages of 64), 4 slots and max_seq_len 1024 each: serve's 4
              prompts handed off into each decode cell, JSON and ndjson,
              give serve's greedy tokens; each export moves 131,072 bytes
              a prompt token (bf16); no capture in the traffic; a profiled
              handoff into each decode cell launches K1 in its replays as
              the captures record; (b) the reference's disagg arm
              (bench.py:505-521) at 8B: 16 streamed sessions on one
              prefixId, a 256-token prefix, tails of 32 and 128, 16 and 64
              greedy tokens, through a paged cell with 8 slots on a
              64-page pool as the mixed arm, then as the decode cell
              behind the legacy prefill cell; each arm first runs 3
              sessions to capture its keys (as the reference warms), then
              all 16 measured: client TTFT p50/p95 to the first ndjson
              line, tokens/s, export ms, wire bytes and import to first
              line (p50), the decode engine's 16-step replay ms a step,
              prefix hits, no capture, the warm sessions' tokens again
  serve_embed  the port's EmbeddingCell("bge-base") at full width and
              depth, bf16, 16-row grids, over HTTP: 64 inputTokens sequences
              of 8-512 tokens over every length bucket, in bursts of 16
              (a warm pass, then a timed one: seq/s, burst latency p50),
              and a few "inputs" strings; every vector of unit norm, each
              within cosine 0.999 of the port's f32 forward of the same
              weights, one sequence alone and inside a padded grid within
              cosine 0.9999, and /metrics counting the sequences
  serve_tp_cells  the MoE family and the embedding cell on a mesh, on the
              one card, after serve_embed (serve_moe's cell is freed by
              then): (a) K2 against its plain version at each rank's
              Mixtral-8x7B expert shapes for t = 2, 4 and 8 (w_gate/w_up
              x[8, C, 4096] @ q[8, 4096, 14336/t], w_down x[8, C, 14336/t]
              @ q[8, 14336/t, 4096]), C in {1, 4, 16, 64} with every row
              filled and C 4 with a routed decode step's rows, whose empty
              rows must be +0; K1 at each rank's trunk (wq N 4096/t, wk and
              wv N 1024/t, wo K 4096/t) and untied head (32000/t padded to
              128-wide tiles: 16000, 8064, 4096), B 4; the route each call
              took, cold-L2 ms beside the bound, and one rank's K2 and K1
              sums for a decode step; (b) ServingCell("mixtral-8x7b",
              dtype="int8", chips=1) through serve_model: a one-rank NCCL
              group at full width and depth, serve_moe's greedy tokens
              bitwise, 129 K1 and 96 K2 a step in the replays, its ms a
              step beside serve_moe's; (c) EmbeddingCell("bge-base",
              chips=1) over the same group: serve_embed's vectors bit for
              bit; (d) both cells' main with --chips 2 on the one card
              (started beside (a)) exit 1 with the over-grant message; (e)
              an HF Mixtral-8x7B
              directory at full width cut to 1 of 32 layers (bf16, ~3 GB,
              drawn on the card and written by the port's writer), read by
              the ranks of t = 8 at once, each in a process of its own, as
              serve_stream's (c), through hf_convert.moe_rank_leaves (int8:
              every expert matrix's rows or columns in staging blocks,
              quantized on the card): each rank's leaves sum as the block
              of the one-device tree quantized on the card; per rank its
              seconds, its blocks' bytes, the most a read declared on the
              host and its process's VmRSS growth. Times only: nothing
              here spans two GPUs
  train       the port's trainer through its entry point
              (kukeon_tpu_torch.training.cli.main): llama3-1b at full width
              and depth, bf16, B 4, S 2048, 8 steps with a checkpoint at 8
              (orbax, the JAX TrainState's layout), then a resumed run
              of 2 more steps; the loss falls, 32 flash launches a step,
              restored params equal the saved ones; each save's seconds and
              its step directory's bytes
  train_tp    the trainer on a mesh: (a) the flash kernel at a llama3-8b
              train rank's shard shapes (train's B 4, S 2048; D 128; H
              32/t, KV 8/t at t 2, 4, 8) against its plain version, cold-L2
              and device ms beside the bound and SDPA's; (b) llama3-1b at
              full width and depth through MeshTrainer on a one-rank NCCL
              group (parallel.mesh.make_mesh), train's init, dataset and
              batches: its losses equal train's at the same steps bit for
              bit, 32 flash launches a step, step ms beside train's, peak
              memory, and a llama3-8b rank's train-state bytes at fsdp 8
              and at fsdp 4 x tensor 2, counted from its local meta tree
              (nothing allocated); (c) the CLI's --fsdp 2 on one card exits
              with the over-grant message before any byte is allocated.
              Nothing here spans two GPUs
  train_moe   Mixtral-8x7B at full width and 4 layers (6.07 B parameters),
              bf16, B 2, S 2048, 6 steps through create_moe_train_state and
              make_moe_train_step (init and batches from one seed, as the
              CLI's --seed): a no-grad forward with the reference
              attention first (its loss within 1e-2 of step 1's), the
              losses finite and falling, 8 flash launches a step; step ms,
              tok/s, peak memory and mfu; then the CLI's mixtral-tiny branch,
              4 steps and 2 resumed from its orbax checkpoint, gated as train
  train_moe_tp  MoE training on a mesh: (a) the flash kernel at a Mixtral
              train rank's shard shapes (B 2, S 2048, D 128; H 32/t, KV 8/t
              at t 2, 4, 8) against its plain version, cold-L2 and device
              ms beside the bound and SDPA's; (b) train_moe's Mixtral-8x7B
              cut through MeshTrainer (cfg=) on a one-rank NCCL group,
              train_moe's init, dataset and batches: its losses, ce, lb and z
              equal train_moe's first 3 steps bit for bit, 8 flash launches
              a step, step ms beside train_moe's, peak memory, and a
              full-depth Mixtral rank's train-state bytes at expert 8 and at
              fsdp 4 x expert 2 (counted, nothing allocated); (c) the CLI's
              --expert 2 on one card exits with the over-grant message
              before any byte is allocated. Nothing here spans two GPUs
  train_sp_pp  sequence and pipeline parallelism: (a) the ring's body
              (parallel/ring_attention.py's block update) at a llama3-1b
              seq rank's shapes, S 8192 over 4 blocks of 2048, H 32, KV 8,
              D 64, bf16: the 4 query blocks' updates over the kv blocks in
              ring order against one whole causal attention in f32, within
              one bf16 rounding; one block update and Ulysses' local
              attention (S 8192, H 8, KV 2) timed forward and with their
              backward, beside their bounds and SDPA; the flash kernel at
              each shape a GPipe stage gives it (a microbatch's rows: B 2
              and B 1 at H 32, KV 8, D 64, B 1 at H 16, KV 4, and at D
              128) against its plain version; (b) llama3-1b through
              MeshTrainer's GPipe step (2 microbatches) on a one-rank NCCL
              group, train's data, seed and init, 3 steps: each loss within
              1e-3 of train's, 32 flash launches a step (no remat), step ms
              beside train's, peak memory, a llama3-8b stage's train-state
              bytes at pipe 4; (c) the CLI's --seq 2 and --pipe 2 on one
              card exit with the over-grant message before any byte is
              allocated. Nothing here spans two GPUs
  train_moe_sp  the MoE family on a seq axis: one full-width Mixtral-8x7B
              MoE layer's router (H 4096, E 8, K 2, drawn from a seed) over
              train_moe's batch shape (B 2, S 2048): one device's dispatch
              of the whole batch, then each rank's through
              moe._row_offsets on a stand-in mesh whose gather returns
              every rank's per-row counts, for the 4 ranks of seq=4 and of
              data=2,seq=2; each rank's dispatch equals its block of the
              whole bit for bit at capacity_factor 2.0 (the preset's) and
              1.0, where something must drop (the dropped share printed);
              (b) llama.seq_attention with "auto", a seq rank's attention
              in both families, at a Mixtral seq rank's shapes (B 4, S
              2048 over seq 2 and 4, H 32, KV 8, D 128, bf16) through a
              stand-in mesh: one flash launch a rank, counted from 0, for
              its block of queries against every key, each held against
              its plain version; the last block timed beside its bound,
              the plain version and masked SDPA
  gpu_grants  GPU discovery and grants on the card's host
              (runtime/devices.py): discover_gpus finds as many GPUs as
              nvidia-smi -L lists; a GPUDeviceManager over a temporary
              store grants 1 GPU, a second manager reads the grant back,
              and a grant of more than is free raises FailedPrecondition; a
              child process started with visibility_env(grant) sees one
              device, whose UUID is nvidia-smi's for the GPU whose minor
              number was granted (nvidia-smi -q's Minor Number gives its
              index; where nvidia-smi hides UUIDs on a one-GPU host, this
              process's); device_nodes(grant) all exist. Prints the
              granted GPU's minor number, nvidia-smi index and CUDA
              ordinal, and what a child under the minor number taken as a
              CUDA ordinal sees

Serving decodes through CUDA graph replays, where the kernels' Python
launch counters move only while a graph is captured. So a serve phase
counts its kernels from what torch.profiler sees inside the replays of its
profiled HTTP window (a fresh profile: every count starts at 0), checks
them against each program's launches recorded at capture times its
replays, and holds the wrappers' counters at 0 across its traffic (no
capture after warmup). The kernels line's ``launches`` are those profiler
counts.

The last lines: the nvidia-smi line, a {"kernels": [...]} line, and
{"ok": true, "device": {...}}. Exits nonzero without a CUDA device, and
in a directory that holds this file and nothing else of the repository.
"""

from __future__ import annotations

import argparse
import atexit
import concurrent.futures
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import resource
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

# Peak HBM bandwidth by card (NVIDIA data sheets), bytes/s, and the dense
# bf16 tensor-core rate, FLOP/s. Rates assume the full power limit.
HBM_BPS = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
           ("H100", 3.35e12))
BF16_FLOPS = 989e12
K1_REPLACES = "kukeon_tpu/ops/int8_matmul.py:40"      # _kernel
K1T_REPLACES = "kukeon_tpu/ops/int8_matmul.py:46"     # _kernel_t
K1_SOURCE = "kukeon_tpu_torch/csrc/int8_matmul.cu"
K2_REPLACES = "kukeon_tpu/ops/int8_matmul.py:101"     # int8_matmul_expert
K3_REPLACES = "kukeon_tpu/ops/flash_attention.py:36"  # _flash_kernel
K3_SOURCE = "kukeon_tpu_torch/csrc/flash_attention.cu"
# Flash cases: (label, B, S, H, KV, D, dtype, position offsets per batch row).
FLASH_CASES = (
    ("llama3-1b train", 4, 2048, 32, 8, 64, torch.bfloat16, None),
    ("mixtral train", 2, 2048, 32, 8, 128, torch.bfloat16, None),
    ("llama3-8b heads", 1, 1024, 32, 8, 128, torch.bfloat16, None),
    ("offset positions", 2, 1024, 8, 2, 64, torch.bfloat16, (100, 7)),
    ("KV = H", 2, 1024, 8, 8, 64, torch.bfloat16, None),
    ("ragged S", 2, 160, 8, 2, 64, torch.bfloat16, None),
    ("f32", 1, 256, 4, 2, 32, torch.float32, (5, )),
)
K3_DESIGN = ("persistent, wgmma + TMA: 128-row q tiles, producer warpgroup with a "
             "3-stage (2 at D 128) K/V ring and double-buffered Q, two consumer "
             "warpgroups taking turns on the tensor cores, P from registers, V MN-major")
K1_DESIGN = ("bf16: one launch; 128-column tiles x at most 8 K slices, 4-stage cp.async "
             "ring of weights and rows of h, mma.sync m16n8k16 with exact prmt/fadd "
             "int8->bf16; the slices of a tile form a cluster that sums them in slice "
             "order through distributed shared memory")
K1T_DESIGN = ("bf16: one launch; 128-row tiles of q x K slices (2 at the 1B head), the "
              "rows of q as mma.sync m16n8k16's A operand as they lie, each warp summing "
              "its own 16 columns over every k; K1's 4-stage cp.async ring and exact "
              "prmt/fadd int8->bf16 (adjacent k of one row); slices summed in a cluster "
              "in slice order through distributed shared memory")
K2_DESIGN = ("bf16: zero-expert skip, 4-stage cp.async weight ring, mma.sync "
             "m16n8k16 with exact prmt/fadd int8->bf16, fixed-order split-K reduce")
MOE_TOKENS, MOE_TOP_K = 4, 2
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_MORE = 4, 2048, 8, 2
# train_moe: Mixtral-8x7B at full width, cut to MOE_TRAIN_LAYERS layers
# (bf16 params, grads and both moments: 8 bytes a parameter, 48.5 GB at 4
# layers), and the CLI's mixtral-tiny run.
MOE_TRAIN_LAYERS, MOE_TRAIN_B, MOE_TRAIN_S, MOE_TRAIN_STEPS = 4, 2, 2048, 6
# train_moe's seed (its init and its batches, as the CLI's --seed), and the
# steps train_moe_tp (b) holds to train_moe's.
MOE_TRAIN_SEED, MOE_TP_STEPS = 2, 3
TINY_MOE_B, TINY_MOE_S, TINY_MOE_STEPS, TINY_MOE_MORE = 4, 128, 4, 2
# serve_ckpt: the checkpoint's model and shard size, and serve_tied's
# traffic (max_seq_len, prompt length, new tokens).
CKPT_MODEL, CKPT_SHARD_BYTES = "llama3-1b", 1 << 30
CKPT_SEQ, CKPT_PROMPT, CKPT_NEW = 256, 32, 16
# serve_orbax: the JAX-written fixture (and its hashes beside it), and the
# seed of the weights written.
ORBAX_FIXTURE, ORBAX_SEED = os.path.join("tests", "data", "orbax_llama_tiny"), 23
# serve_embed: bge-base's grid rows and traffic.
EMBED_GRID, EMBED_SEQS, EMBED_BURST = 16, 64, 16
# (K, N) of the llama3-8b decode projections, with launches per step.
SHAPES_8B = {"wq": (4096, 4096, 32), "wk": (4096, 1024, 32), "wv": (4096, 1024, 32),
             "wo": (4096, 4096, 32), "w_gate": (4096, 14336, 32),
             "w_up": (4096, 14336, 32), "w_down": (14336, 4096, 32),
             "lm_head": (4096, 128256, 1)}
TIED_1B = (2048, 128256)
# More transposed (K, N), checked at every B: their K slices form clusters
# of up to 8 blocks, where the 1B head takes 2.
TIED_CHECKS = ((4096, 4096), (4096, 1024), (14336, 4096))
BATCHES = (1, 3, 4, 16, 64)
# Mixtral-8x7B decode: (K, N, launches per step) of the trunk's int8_matmul
# calls and of the expert stacks' int8_matmul_expert calls (E experts each).
MOE_E = 8
SHAPES_MIXTRAL = {"wq": (4096, 4096, 32), "wk": (4096, 1024, 32), "wv": (4096, 1024, 32),
                  "wo": (4096, 4096, 32), "lm_head": (4096, 32000, 1)}
SHAPES_MOE = {"w_gate": (4096, 14336, 32), "w_up": (4096, 14336, 32),
              "w_down": (14336, 4096, 32)}
# Flash past the shape cases: (label, B, S, H, KV, D, query rows checked
# per slice, or None for all). 65792 is the first S above 65536 that
# supports() admits: the kernel's kv-tile lists leave shared memory.
FLASH_LONG = (("S 8192", 1, 8192, 8, 2, 64, None),
              ("S 65792", 1, 65792, 1, 1, 64, 256))
PHASES = ("card", "kernel", "flash", "moe_kernel", "model", "serve", "serve_obs",
          "serve_stream", "serve_tune", "serve_tp", "serve_tied", "serve_ckpt", "serve_orbax",
          "serve_tiny", "moe_model", "graph_decode", "graph_prefill", "graph_paged",
          "serve_moe", "serve_prefix", "serve_paged", "serve_disagg", "serve_embed",
          "serve_tp_cells", "train", "train_tp", "train_moe",
          "train_moe_tp", "train_sp_pp", "train_moe_sp", "gpu_grants")   # in run order
# Kernels a decode step launches inside the graphs, by model: K1, K1t, K2.
STEP_LAUNCHES = {"llama3-8b": {"k1": 225, "k1t": 0, "k2": 0},
                 "llama3-1b": {"k1": 112, "k1t": 1, "k2": 0},
                 "mixtral-8x7b": {"k1": 129, "k1t": 0, "k2": 96}}
# Kernel names in the profiler, and the programs' launch counters, by key.
KERNEL_NAMES = {"k1": "int8_mm_bf16_kernel", "k1t": "int8_mm_t_bf16_kernel",
                "k2": "int8_mm_expert_bf16_kernel"}
COUNTERS = {"k1": "int8_matmul", "k1t": "int8_matmul_transposed", "k2": "int8_matmul_expert"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def phase(name: str, out: dict):
    t0 = time.monotonic()
    yield out
    out["phase"] = name
    out["wall_s"] = round(time.monotonic() - t0, 3)
    emit(out)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def hbm_bps(name: str) -> float:
    return next(bps for key, bps in HBM_BPS if key in name)


def cold_median_ms(fn, flush: torch.Tensor, runs: int = 20, warm: int = 3) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn``, each after the L2
    cache is overwritten (decode finds its weights cold)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(B: int, K: int, N: int, bps: float, E: int = 1) -> tuple[float, str]:
    """Least time for h[B,K] bf16 @ int8 [K,N] * s[N] (E such products for
    the experts): each input read once, the bf16 output written once, over
    the peak HBM rate; or the 2BKN operations over the bf16 rate, whichever
    is larger."""
    t_bytes = E * (K * N + 4 * N + 2 * B * K + 2 * B * N) / bps * 1e3
    t_ops = E * 2 * B * K * N / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def within_tol(out: torch.Tensor, ref: torch.Tensor) -> tuple[bool, float, float]:
    """Kernel vs plain version, both in the working dtype: every element
    within 1 ulp of its own magnitude (2^-7 relative in bf16, 2^-20 in f32:
    the f32 sums differ only in order, then one rounding) plus 1e-3 of the
    output's RMS for outputs near zero, where reordered f32 sums dominate."""
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    ulp = 2.0 ** -7 if ref.dtype == torch.bfloat16 else 2.0 ** -20
    rms = r.pow(2).mean().sqrt()
    ok = bool(torch.all(err <= ulp * r.abs() + 1e-3 * rms))
    return ok, float(err.max()), float((err / (r.abs() + rms)).max())


def library_call(h, q_kn, s):
    """One PyTorch call for the same function, where the installed build
    has it on CUDA: torch._weight_int8pack_mm (q [N,K], scale in h's dtype).
    Else dequant + torch.matmul, labelled as two calls."""
    q_nk = q_kn.T.contiguous()
    s_h = s.to(h.dtype)
    try:
        torch._weight_int8pack_mm(h, q_nk, s_h)
        torch.cuda.synchronize()
        return (lambda: torch._weight_int8pack_mm(h, q_nk, s_h)), "torch._weight_int8pack_mm"
    except (RuntimeError, NotImplementedError, AttributeError):
        return (lambda: (h @ q_kn.to(h.dtype)) * s_h), "dequant+torch.matmul (2 calls)"


def phase_kernel(k1, bps: float, flush: torch.Tensor) -> dict:
    """Hold the kernel against its plain version at every shape; time it at
    B = 4. Returns the per-step K1 and the K1t entries' numbers."""
    g = torch.Generator(device="cuda").manual_seed(1)
    cases = [(name, K, N, False) for name, (K, N, _n) in SHAPES_8B.items()
             if name not in ("wv", "wo", "w_up")]          # shapes repeat
    cases.append(("tied_head_1b", TIED_1B[0], TIED_1B[1], True))
    cases += [(f"tied_{K}x{N}", K, N, True) for K, N in TIED_CHECKS]
    worst_abs, worst_rel, timings, lib_label, checks_ms = 0.0, 0.0, {}, None, {}
    for name, K, N, transpose in cases:
        qshape = (N, K) if transpose else (K, N)
        q = torch.randint(-127, 128, qshape, generator=g, device="cuda", dtype=torch.int8)
        s = torch.rand(N, generator=g, device="cuda") * 0.02 + 1e-3
        for B in BATCHES:
            h = torch.randn((B, K), generator=g, device="cuda").to(torch.bfloat16)
            out = k1.int8_matmul(h, q, s, transpose=transpose)
            ref = k1.int8_matmul_reference(h, q, s, transpose=transpose)
            torch.cuda.synchronize()
            ok, ea, er = within_tol(out, ref)
            if not ok or not torch.isfinite(out).all():
                raise AssertionError(f"int8_matmul disagrees with its plain version at "
                                     f"{name} B={B}: max abs {ea}, max rel {er}")
            worst_abs, worst_rel = max(worst_abs, ea), max(worst_rel, er)
            if B != 4:
                continue
            if transpose and name != "tied_head_1b":
                checks_ms[f"{K}x{N}"] = round(sum(kernel_device_ms(
                    lambda: k1.int8_matmul(h, q, s, transpose=True), flush).values()), 4)
                continue
            t = {"ms": cold_median_ms(lambda: k1.int8_matmul(h, q, s, transpose=transpose), flush),
                 "plain_ms": cold_median_ms(
                     lambda: k1.int8_matmul_reference(h, q, s, transpose=transpose), flush)}
            lib, lib_label = library_call(h, q.T if transpose else q, s)
            t["library_ms"] = cold_median_ms(lib, flush)
            t["bound_ms"], t["bound_by"] = bound_ms(4, K, N, bps)
            t["device_ms"] = sum(kernel_device_ms(
                lambda: k1.int8_matmul(h, q, s, transpose=transpose), flush).values())
            t["max_abs_err"] = ea
            timings[name] = t
        del q, s
    # f32 activations (llama_tiny's dtype) take the kernel's float path.
    h = torch.randn((4, 4096), generator=g, device="cuda")
    q = torch.randint(-127, 128, (4096, 4096), generator=g, device="cuda", dtype=torch.int8)
    s = torch.rand(4096, generator=g, device="cuda") * 0.02
    ok, ea32, _ = within_tol(k1.int8_matmul(h, q, s), k1.int8_matmul_reference(h, q, s))
    if not ok:
        raise AssertionError(f"int8_matmul f32 path disagrees: max abs {ea32}")
    # f32 with transpose=True (llama_tiny's tied head) keeps the first
    # design's transposed kernel: held at the 1B head's q [N, K], every B.
    q = torch.randint(-127, 128, (TIED_1B[1], TIED_1B[0]), generator=g, device="cuda",
                      dtype=torch.int8)
    s = torch.rand(TIED_1B[1], generator=g, device="cuda") * 0.02 + 1e-3
    ea32t = 0.0
    for B in BATCHES:
        h = torch.randn((B, TIED_1B[0]), generator=g, device="cuda")
        out = k1.int8_matmul(h, q, s, transpose=True)
        ok, ea, _ = within_tol(out, k1.int8_matmul_reference(h, q, s, transpose=True))
        if not ok or not torch.isfinite(out).all():
            raise AssertionError(f"int8_matmul f32 transposed path disagrees at B={B}: "
                                 f"max abs {ea}")
        ea32t = max(ea32t, ea)
    del q, s
    for name in ("wv", "wo", "w_up"):
        timings[name] = timings[{"wv": "wk", "wo": "wq", "w_up": "w_gate"}[name]]
    return {"timings": timings, "max_abs_err": worst_abs, "max_rel_err": worst_rel,
            "f32_max_abs_err": ea32, "f32_transposed_max_abs_err": ea32t,
            "library_call": lib_label, "transposed_device_ms_b4": checks_ms,
            "tolerance": "|err| <= 2^-7 |ref| + 1e-3 rms(ref) (bf16), 2^-20 (f32)"}


def k1_one_launch(k1) -> dict:
    """The bf16 routes of K1 and K1t: a second call at every 8B shape and
    at the 1B tied head (B 4 and 64) gives the first call's bits (every sum
    in a fixed order), and one call of each is one kernel launch in the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cuda").manual_seed(4)
    cases = [(name, K, N, False) for name, (K, N, _n) in SHAPES_8B.items()]
    cases.append(("tied_head_1b", TIED_1B[0], TIED_1B[1], True))
    per_call = {}
    for name, K, N, transpose in cases:
        q = torch.randint(-127, 128, (N, K) if transpose else (K, N), generator=g, device="cuda",
                          dtype=torch.int8)
        s = torch.rand(N, generator=g, device="cuda") * 0.02 + 1e-3
        for B in (4, 64):
            h = torch.randn((B, K), generator=g, device="cuda").to(torch.bfloat16)
            first = k1.int8_matmul(h, q, s, transpose=transpose)
            second = k1.int8_matmul(h, q, s, transpose=transpose)
            torch.cuda.synchronize()
            if not torch.equal(first.view(torch.int16), second.view(torch.int16)):
                raise AssertionError(f"int8_matmul: a repeated call at {name} B={B} "
                                     f"gave other bits")
        if name in ("lm_head", "tied_head_1b"):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                k1.int8_matmul(h, q, s, transpose=transpose)
                torch.cuda.synchronize()
            kernels = {e.key[:60]: e.count for e in device_kernels(prof)}
            if sum(kernels.values()) != 1:
                raise AssertionError(f"one bf16 int8_matmul call at {name} launched "
                                     f"{kernels}, want 1 kernel")
            per_call["t" if transpose else "k1"] = kernels
        del q, s
    return {"kernels_per_call": per_call["k1"], "kernels_per_call_t": per_call["t"],
            "repeat_bit_identical": True}


def expert_library_call(x, q, s):
    """The same grouped product through PyTorch: no single call computes it,
    so E calls of torch._weight_int8pack_mm (q [N,K], scale in x's dtype)
    where the installed build has it on CUDA, else dequant + torch.bmm."""
    E = x.shape[0]
    try:
        q_nk = [q[e].T.contiguous() for e in range(E)]
        s_x = [s[e].to(x.dtype) for e in range(E)]
        torch._weight_int8pack_mm(x[0], q_nk[0], s_x[0])
        torch.cuda.synchronize()

        def run():
            for e in range(E):
                torch._weight_int8pack_mm(x[e], q_nk[e], s_x[e])
        return run, f"torch._weight_int8pack_mm ({E} calls)"
    except (RuntimeError, NotImplementedError, AttributeError):
        return ((lambda: torch.bmm(x, q.to(x.dtype)) * s[:, None, :].to(x.dtype)),
                "dequant+torch.bmm (3 calls)")


def decode_routing(g: torch.Generator) -> list[int]:
    """Tokens per expert at one Mixtral decode step: MOE_TOKENS tokens, each
    routed to its top MOE_TOP_K of MOE_E experts by seeded router logits.
    Dense dispatch fills an expert's first n slots (full capacity, C =
    MOE_TOKENS) and leaves the rest, and every slot of an expert no token
    chose, at exactly 0."""
    logits = torch.randn((MOE_TOKENS, MOE_E), generator=g, device="cuda")
    top = logits.topk(MOE_TOP_K, dim=-1).indices
    return torch.bincount(top.flatten(), minlength=MOE_E).tolist()


def kernel_device_ms(fn, flush: torch.Tensor, calls: int = 5) -> dict:
    """Device ms a call of each kernel ``fn`` launches: torch.profiler over
    ``calls`` calls, each after the L2 cache is overwritten (as for
    cold_median_ms), the overwrite's own kernel left out."""
    from torch.profiler import ProfilerActivity, profile

    def rows(body) -> dict:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                body()
            torch.cuda.synchronize()
        return {e.key[:48]: round(dev_us(e) / 1e3 / calls, 4) for e in device_kernels(prof)}

    drop = rows(flush.zero_)
    return {k: v for k, v in rows(lambda: (flush.zero_(), fn())).items() if k not in drop}


def phase_moe_kernel(k1, bps: float, flush: torch.Tensor) -> dict:
    """Hold the grouped expert kernel against its plain version at both
    Mixtral-8x7B expert shapes and every C; time it at C = 4, every
    expert's rows filled and with the rows of a routed decode step."""
    g = torch.Generator(device="cuda").manual_seed(2)
    counts = decode_routing(g)
    empty = [e for e in range(MOE_E) if counts[e] == 0]
    worst_abs, worst_rel, timings, lib_label, split = 0.0, 0.0, {}, None, {}
    for name in ("w_gate", "w_down"):
        K, N, _n = SHAPES_MOE[name]
        q = torch.randint(-127, 128, (MOE_E, K, N), generator=g, device="cuda",
                          dtype=torch.int8)
        s = torch.rand((MOE_E, N), generator=g, device="cuda") * 0.02 + 1e-3
        for C in BATCHES:
            x = torch.randn((MOE_E, C, K), generator=g, device="cuda").to(torch.bfloat16)
            out = k1.int8_matmul_expert(x, q, s)
            ref = k1.int8_matmul_expert_reference(x, q, s)
            torch.cuda.synchronize()
            ok, ea, er = within_tol(out, ref)
            if not ok or not torch.isfinite(out).all():
                raise AssertionError(f"int8_matmul_expert disagrees with its plain version "
                                     f"at {name} C={C}: max abs {ea}, max rel {er}")
            worst_abs, worst_rel = max(worst_abs, ea), max(worst_rel, er)
            if C != 4:
                continue
            lib, lib_label = expert_library_call(x, q, s)
            t = {"ms": cold_median_ms(lambda: k1.int8_matmul_expert(x, q, s), flush),
                 "plain_ms": cold_median_ms(
                     lambda: k1.int8_matmul_expert_reference(x, q, s), flush),
                 "library_ms": cold_median_ms(lib, flush)}
            t["bound_ms"], t["bound_by"] = bound_ms(4, K, N, bps, MOE_E)
            t["max_abs_err"] = ea
            timings[name] = t
            split[name] = kernel_device_ms(lambda: k1.int8_matmul_expert(x, q, s), flush)
        # The rows of a decode step: expert e's first counts[e] slots filled.
        x = torch.zeros((MOE_E, MOE_TOKENS, K), device="cuda", dtype=torch.bfloat16)
        for e, n in enumerate(counts):
            x[e, :n] = torch.randn((n, K), generator=g, device="cuda").to(torch.bfloat16)
        out = k1.int8_matmul_expert(x, q, s)
        ref = k1.int8_matmul_expert_reference(x, q, s)
        torch.cuda.synchronize()
        ok, ea, er = within_tol(out, ref)
        if not ok or not torch.isfinite(out).all():
            raise AssertionError(f"int8_matmul_expert disagrees with its plain version at "
                                 f"{name}, routed rows {counts}: max abs {ea}, max rel {er}")
        for e, n in enumerate(counts):     # zero rows give exactly +0 (bits 0)
            if not (torch.all(out[e, n:].view(torch.int16) == 0)
                    and torch.all(ref[e, n:].view(torch.int16) == 0)):
                raise AssertionError(f"int8_matmul_expert: zero rows of expert {e} at {name} "
                                     f"are not +0 (routed rows {counts})")
        lib, _ = expert_library_call(x, q, s)
        t = {"ms": cold_median_ms(lambda: k1.int8_matmul_expert(x, q, s), flush),
             "plain_ms": cold_median_ms(lambda: k1.int8_matmul_expert_reference(x, q, s), flush),
             "library_ms": cold_median_ms(lib, flush)}
        t["bound_ms"], t["bound_by"] = bound_ms(4, K, N, bps, MOE_E - len(empty))
        t["device_ms"] = sum(kernel_device_ms(lambda: k1.int8_matmul_expert(x, q, s),
                                              flush).values())
        t["max_abs_err"] = ea
        t["empty_experts"] = len(empty)
        timings[name + "_routed"] = t
        del q, s
    # f32 activations take the kernel's float path.
    x = torch.randn((MOE_E, 4, 4096), generator=g, device="cuda")
    q = torch.randint(-127, 128, (MOE_E, 4096, 1024), generator=g, device="cuda",
                      dtype=torch.int8)
    s = torch.rand((MOE_E, 1024), generator=g, device="cuda") * 0.02
    ok, ea32, _ = within_tol(k1.int8_matmul_expert(x, q, s),
                             k1.int8_matmul_expert_reference(x, q, s))
    if not ok:
        raise AssertionError(f"int8_matmul_expert f32 path disagrees: max abs {ea32}")
    timings["w_up"] = timings["w_gate"]
    timings["w_up_routed"] = timings["w_gate_routed"]
    return {"timings": timings, "max_abs_err": worst_abs, "max_rel_err": worst_rel,
            "f32_max_abs_err": ea32, "library_call": lib_label, "experts": MOE_E,
            "routing_tokens_per_expert": counts, "empty_experts": len(empty),
            "device_ms_per_call_c4": split,
            "tolerance": "|err| <= 2^-7 |ref| + 1e-3 rms(ref) (bf16), 2^-20 (f32); "
                         "zero rows exactly +0"}


def logits_agree(a: torch.Tensor, b: torch.Tensor, stage: str) -> dict:
    """Kernel vs dequant logits [B, V]: cosine >= 0.999 per row and the
    same top-1 on all rows but one."""
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError(f"{stage} logits not finite")
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
    top1 = int((a.argmax(-1) == b.argmax(-1)).sum())
    out = {"min_cosine": float(cos.min()), "top1_agree": f"{top1}/{a.shape[0]}"}
    if float(cos.min()) < 0.999 or top1 < a.shape[0] - 1:
        raise AssertionError(f"{stage}: kernel vs dequant logits {out}")
    return out


def phase_model(k1) -> dict:
    from kukeon_tpu_torch.models import convert, llama

    cfg = llama.llama3_8b()
    g = torch.Generator(device="cuda").manual_seed(0)
    params = convert.init_quantized_params_device(cfg, g, "cuda")
    B, S = 4, 128
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device="cuda")
    pos = torch.arange(S, device="cuda")[None, :].expand(B, S)
    nxt = torch.randint(0, cfg.vocab_size, (B, 1), generator=g, device="cuda")
    logits = {}
    launches = {}
    with torch.no_grad():
        for flag in (True, False):
            c = dataclasses.replace(cfg, int8_pallas=flag)
            cache = llama.KVCache.create(c, B, 256, device="cuda")
            pre, cache = llama.forward(params, c, toks, pos, cache)
            before = k1.int8_matmul.launches
            dec, cache = llama.forward(params, c, nxt, cache.lengths[:, None], cache)
            torch.cuda.synchronize()
            launches[flag] = k1.int8_matmul.launches - before
            logits[flag] = (pre[:, -1].float(), dec[:, 0].float())
    if launches[True] != 225 or launches[False] != 0:
        raise AssertionError(f"decode step launches {launches}, want 225 with the kernel")
    out = {"decode_step_launches": launches[True]}
    for i, stage in enumerate(("prefill", "decode")):
        out[stage] = logits_agree(logits[True][i], logits[False][i], stage)
    out["tolerance"] = "cosine >= 0.999 per row, same top-1 on >= 3 of 4 rows"
    del params
    return out


# A routing decision whose 2nd and 3rd router probabilities lie this close
# is a near tie: the kernel and dequant paths differ by bf16 roundings
# (relative 2^-8 a product, some 1e-2 after 32 layers), which move router
# logits by ~1e-2 and a probability gap by ~1e-2 at most.
NEAR_TIE = 0.02


def phase_moe_model(k1, params) -> dict:
    """mixtral-8x7b int8 (the serving cell's own weights): a prefill and a
    decode step with the kernels on and off. The decode step's launches are
    counted and the logits compared. Each layer's top-2 routing of the two
    runs is compared too: at decode every row is its own token (full
    capacity, no token sees another), so a row whose routing flips on a
    near tie may leave the cosine bound; it must flip on a near tie, keep
    its top-1, and every row routed alike must meet the bound."""
    from kukeon_tpu_torch.models import llama, moe

    cfg = moe.mixtral_8x7b()
    g = torch.Generator(device="cuda").manual_seed(0)
    B, S = 4, 128
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device="cuda")
    pos = torch.arange(S, device="cuda")[None, :].expand(B, S)
    nxt = torch.randint(0, cfg.vocab_size, (B, 1), generator=g, device="cuda")
    logits, launches, routes, wall = {}, {}, {}, {}
    real_block = moe.moe_block
    K = cfg.experts_per_token

    def recording_block(h, w, c, inference=False, kernel=False, mesh=None):
        probs = torch.softmax(h.reshape(-1, h.shape[-1]).float() @ w["router"], dim=-1)
        top = torch.topk(probs, K + 1, dim=-1)
        routes[flag].append((top.indices[:, :K].sort(-1)[0],
                             top.values[:, K - 1] - top.values[:, K]))
        return real_block(h, w, c, inference, kernel, mesh)

    with torch.no_grad():
        for flag in (True, False):
            c = dataclasses.replace(cfg, int8_pallas=flag)
            cache = llama.KVCache.create(c, B, 256, device="cuda")
            torch.cuda.synchronize()
            t0 = time.monotonic()
            pre, cache = moe.forward(params, c, toks, pos, cache)
            torch.cuda.synchronize()
            t1 = time.monotonic()
            before = (k1.int8_matmul.launches, k1.int8_matmul_expert.launches)
            routes[flag] = []
            moe.moe_block = recording_block
            try:
                dec, cache = moe.forward(params, c, nxt, cache.lengths[:, None], cache)
            finally:
                moe.moe_block = real_block
            torch.cuda.synchronize()
            wall[flag] = {"prefill_ms": round((t1 - t0) * 1e3, 3),
                          "decode_step_ms": round((time.monotonic() - t1) * 1e3, 3)}
            launches[flag] = (k1.int8_matmul.launches - before[0],
                              k1.int8_matmul_expert.launches - before[1])
            logits[flag] = (pre[:, -1].float(), dec[:, 0].float())
            del cache
    if launches[True] != (129, 96) or launches[False] != (0, 0):
        raise AssertionError(f"decode step launches (int8_matmul, int8_matmul_expert) "
                             f"{launches}, want (129, 96) with the kernels")
    first_flip = {}
    for layer, ((ia, ga), (ib, gb)) in enumerate(zip(routes[True], routes[False])):
        for row in torch.nonzero(~(ia == ib).all(-1)).flatten().tolist():
            first_flip.setdefault(row, {"layer": layer, "gap_kernel": float(ga[row]),
                                        "gap_dequant": float(gb[row])})
    a, b = logits[True][1], logits[False][1]
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1).tolist()
    top1 = int((a.argmax(-1) == b.argmax(-1)).sum())
    out = {"decode_step_launches": {"int8_matmul": 129, "int8_matmul_expert": 96},
           "host_clock_ms": {"kernels": wall[True], "dequant": wall[False]},
           "prefill": logits_agree(logits[True][0], logits[False][0], "prefill"),
           "decode": {"cosine_per_row": cos, "top1_agree": f"{top1}/{B}",
                      "first_routing_flip_by_row": first_flip},
           "routing_agreement_per_layer": [float((ia == ib).all(-1).float().mean())
                                           for (ia, _), (ib, _) in zip(routes[True],
                                                                       routes[False])],
           "tolerance": f"cosine >= 0.999 on every row routed alike at every layer; a row "
                        f"that flips does so first where both runs' 2nd-3rd router "
                        f"probability gap is <= {NEAR_TIE}; same top-1 on >= 3 of 4 rows"}
    ok = (torch.isfinite(a).all() and torch.isfinite(b).all() and top1 >= B - 1
          and all(cos[r] >= 0.999 for r in range(B) if r not in first_flip)
          and all(max(f["gap_kernel"], f["gap_dequant"]) <= NEAR_TIE
                  for f in first_flip.values()))
    if not ok:
        raise AssertionError(f"decode: kernel vs dequant {out}")
    return out


def post(url: str, body: dict, headers: dict | None = None) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def dev_us(e) -> float:
    """Device time of a profiler row, in microseconds."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def device_kernels(prof) -> list:
    """The profiler's kernel rows (not the host-side operators, whose
    device time repeats their kernels')."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]


def post_all(base: str, prompts: list, new: int) -> list:
    """The prompts as concurrent HTTP requests, ``new`` greedy tokens each."""
    return post_bodies(base, [{"promptTokens": p, "maxNewTokens": new} for p in prompts])


def post_bodies(base: str, bodies: list, traceparents: list | None = None) -> list:
    """The generate bodies as concurrent HTTP requests -> their answers
    (``traceparents``: each request's ``traceparent`` header)."""
    results = [None] * len(bodies)

    def run(i):
        results[i] = post(base + "/v1/generate", bodies[i],
                          {"traceparent": traceparents[i]} if traceparents else None)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return results


def profile_serving(base: str, engine, prompts, new: int) -> dict:
    """torch.profiler over HTTP requests to the running cell: device busy
    share of the wall time, the kernels that take the device time, the
    host operators that take the host's, and the kernel launches inside
    the decode graphs' replays, against each program's launches recorded
    at capture times its replays in the window; and the prefill programs'
    replays (one ``cudaGraphLaunch`` each, prefill and insert together)."""
    from torch.profiler import ProfilerActivity, profile

    stats = engine.program_stats
    before = {"steps": stats["steps"], "replays": stats["replays"],
              "by_key": dict(stats["replays_by_key"]),
              "prefill_replays": stats["prefill"]["replays"]}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        results = post_all(base, prompts, new)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    if any(r is None or r["numTokens"] != new for r in results):
        raise AssertionError(f"a profiled request came back wrong: {results}")

    rows = prof.key_averages()
    kernels = device_kernels(prof)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    host = sorted((e for e in rows if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    steps = stats["steps"] - before["steps"]
    replays = stats["replays"] - before["replays"]
    seen = {k: sum(e.count for e in kernels if name in e.key) for k, name in KERNEL_NAMES.items()}
    by_capture = {k: sum((n - before["by_key"].get(key, 0)) * stats["launches_by_key"][key][c]
                         for key, n in stats["replays_by_key"].items())
                  for k, c in COUNTERS.items()}
    return {"wall_ms": round(wall_ms, 2), "device_busy_ms": round(busy_ms, 2),
            "device_idle_share": round(1 - busy_ms / wall_ms, 4),
            "decode_steps": steps, "replays": replays,
            "prefill_replays": stats["prefill"]["replays"] - before["prefill_replays"],
            "graph_launches": sum(e.count for e in rows if "cudaGraphLaunch" in e.key),
            "launches": seen, "launches_capture_x_replays": by_capture,
            "launches_per_step": {k: round(v / max(steps, 1), 3) for k, v in seen.items()},
            "top_device_ms": [[e.key[:60], round(dev_us(e) / 1e3, 3), e.count] for e in top],
            "top_host_self_ms": [[e.key[:60], round(e.self_cpu_time_total / 1e3, 3), e.count]
                                 for e in host]}


def make_cell(model: str, max_seq_len: int, kv_page_tokens: int = 0, role: str = "mixed",
              chips: int | None = None):
    from kukeon_tpu_torch.runtime.serving_cell import ServingCell

    return ServingCell(model, dtype="int8", num_slots=4, max_seq_len=max_seq_len,
                       device="cuda", kv_page_tokens=kv_page_tokens, role=role, chips=chips)


def twin_cell(cell, kv_page_tokens: int = 64, role: str | None = None,
              num_slots: int | None = None, kv_pool_pages: int | None = None,
              decode_chunk: int | None = None, kv_cache_int8: bool = False):
    """A cell over ``cell``'s weights (no second draw), with an engine of
    its own: by default the paged KV layout (pages of 64) at ``cell``'s
    slots and the pool of its legacy cache's rows; ``kv_page_tokens`` 0
    keeps the legacy layout; ``decode_chunk`` (default ``cell``'s) and
    ``kv_cache_int8`` as given."""
    import copy

    from kukeon_tpu_torch.models import moe
    from kukeon_tpu_torch.obs import Registry, SloTracker
    from kukeon_tpu_torch.runtime.serving_cell import MOE_MODELS
    from kukeon_tpu_torch.serving.engine import ServingEngine

    old = cell.engine
    twin = copy.copy(cell)
    registry = Registry()
    twin.engine = ServingEngine(
        cell.cfg, old.params, num_slots=num_slots or old.num_slots,
        max_seq_len=old.max_seq_len, decode_chunk=decode_chunk or old.decode_chunk,
        kv_cache_int8=kv_cache_int8, max_pending=old.max_pending, device="cuda",
        forward_fn=moe.forward if cell.model_name in MOE_MODELS else None,
        kv_page_tokens=kv_page_tokens, kv_pool_pages=kv_pool_pages, registry=registry)
    twin.boot_s = {}
    twin.role = role or cell.role
    twin._init_lifecycle()
    twin._init_cell_obs(registry, "decoder", twin.engine.device, twin.engine)
    twin.slo = SloTracker(registry, cell.slo.objectives)
    return twin


class IdTokenizer:
    """Every token id as visible text, ``<id>``: random weights rarely
    sample the byte tokenizer's 256 byte ids, so its text would be empty
    and a stop string could never match."""

    def decode(self, ids: list) -> str:
        return "".join(f"<{i}>" for i in ids)


def post_stream(url: str, body: dict) -> list:
    """A streamed generate -> its ndjson records."""
    req = urllib.request.Request(url, data=json.dumps({**body, "stream": True}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.headers.get("Content-Type") != "application/x-ndjson":
            raise AssertionError(f"a stream answered {r.headers.get('Content-Type')}")
        return [json.loads(x) for x in r.read().splitlines() if x]


def stream_stop_check(base: str, cell, prompt: list, answer: dict) -> dict:
    """One streamed request with a ``stop`` string over HTTP: the text of
    the non-streamed ``answer`` to ``prompt`` holds the 24th token's text,
    which the stream must stop at; its records' joined text must equal the
    answer's text cut there, the terminal record say ``stopped``, and the
    slot come free (``/v1/stats`` freeSlots back to every slot)."""
    saved, cell.tokenizer = cell.tokenizer, IdTokenizer()
    try:
        full = cell.tokenizer.decode(answer["tokens"])
        stop = f"<{answer['tokens'][23]}>"
        want = full[:full.find(stop)]
        t0 = time.monotonic()
        recs = post_stream(base + "/v1/generate", {"promptTokens": prompt, "stop": stop,
                                                   "maxNewTokens": answer["numTokens"]})
        wall = time.monotonic() - t0
    finally:
        cell.tokenizer = saved
    final = recs[-1]
    joined = "".join(r.get("text", "") for r in recs[:-1])
    if not final.get("done") or not final.get("stopped") or joined != want \
            or final["text"] != want:
        raise AssertionError(f"streamed stop at {stop}: final {final}, joined {joined!r}, "
                             f"want {want!r}")
    free = None
    for _ in range(100):
        with urllib.request.urlopen(base + "/v1/stats", timeout=30) as r:
            free = json.loads(r.read())["freeSlots"]
        if free == cell.engine.num_slots:
            break
        time.sleep(0.05)
    if free != cell.engine.num_slots:
        raise AssertionError(f"after the stop, {free} of {cell.engine.num_slots} slots free")
    return {"stop": stop, "records": len(recs), "tokens_streamed": len(recs) - 1,
            "tokens_in_terminal": final["numTokens"], "stopped": True,
            "joined_text_equal": True, "free_slots_after": free, "wall_s": round(wall, 3)}


# Greedy tokens of each serve run's 4 requests, and their prompts, by
# label: serve_paged, the paged serve_moe check and serve_disagg hold theirs
# to the legacy layout's.
SERVED_TOKENS: dict = {}
# serve_tune's one-device layer profile: its shapes and each component's
# counts, which serve_tp's group profile must give.
TUNE_PROFILE: dict = {}
SERVED_PROMPTS: dict = {}


def serve_model(k1, model: str, *, max_seq_len: int, prompt_len: int, new: int,
                requests: int = 4, profile_new: int = 8, cell=None, label: str | None = None,
                stream_stop: bool = False, keep: dict | None = None) -> dict:
    """The port's main path: ServingCell over HTTP, int8 weights, 4 slots
    (``cell``: one already built, whose boot is then only its warmup;
    ``keep``: the cell is left there under ``label or model``). The
    warmup captures the decode graphs and the prompt bucket's prefill; the
    kernels' launch counters are zeroed just after it and must stay 0, as
    must both programs' capture counts (no capture for this traffic). The
    launches inside the replays are counted in the profiled window, where
    every prefill must be one graph replay."""
    from kukeon_tpu_torch.runtime.serving_cell import serve

    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    cell = cell or make_cell(model, max_seq_len)
    t_draw = time.monotonic()
    cell.warmup(prompt_len)
    cell.engine.start()
    server = serve(cell)
    cell.mark_ready()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    boot_s = time.monotonic() - t0
    stats = cell.engine.program_stats
    pstats = stats["prefill"]
    captures = (stats["captures"], pstats["captures"])
    after_warmup = (stats["captures_after_warmup"], pstats["captures_after_warmup"])
    try:
        with urllib.request.urlopen(base + "/readyz", timeout=30) as r:
            ready = r.status
        g = torch.Generator().manual_seed(7)
        prompts = [torch.randint(0, cell.cfg.vocab_size, (prompt_len,), generator=g).tolist()
                   for _ in range(requests)]
        k1.int8_matmul.launches = k1.int8_matmul.launches_t = 0
        k1.int8_matmul_expert.launches = 0
        t1 = time.monotonic()
        results = post_all(base, prompts, new)
        wall = time.monotonic() - t1
        repeat = post(base + "/v1/generate", {"promptTokens": prompts[0], "maxNewTokens": new})
        torch.cuda.synchronize()
        prof = profile_serving(base, cell.engine, prompts, profile_new)
        short = []
        while (STEP_LAUNCHES.get(model) is not None and len(short) < 2
               and prof["launches"] != prof["launches_capture_x_replays"]
               and prof["graph_launches"] == prof["replays"] + prof["prefill_replays"]):
            # Every graph launch was seen but kernel records are missing:
            # the profiler dropped some (seen once on Mixtral, under one
            # step's worth). Profile the same traffic again, at most twice;
            # the gates below hold the last window as they would the first.
            short.append({k: prof[k] for k in ("launches", "launches_capture_x_replays",
                                               "replays", "graph_launches")})
            prof = profile_serving(base, cell.engine, prompts, profile_new)
        stopped = (stream_stop_check(base, cell, prompts[0], results[0])
                   if stream_stop else None)
        outside = {"k1": k1.int8_matmul.launches - k1.int8_matmul.launches_t,
                   "k1t": k1.int8_matmul.launches_t, "k2": k1.int8_matmul_expert.launches}
    finally:
        server.shutdown()
        server.server_close()
        cell.engine.stop()
    if ready != 200:
        raise AssertionError(f"/readyz answered {ready}")
    for i, r in enumerate(results):
        if r is None or r["numTokens"] != new or len(r["tokens"]) != new:
            raise AssertionError(f"request {i} came back wrong: {r}")
    if repeat["tokens"] != results[0]["tokens"]:
        raise AssertionError("the same prompt sent twice gave different tokens")
    now = (stats["captures"], pstats["captures"])
    if now != captures or any(outside.values()):
        raise AssertionError(f"{model}: a program was captured after warmup ((decode, "
                             f"prefill) captures {captures} -> {now}; wrapper counts "
                             f"{outside})")
    if (prof["replays"] <= 0 or prof["prefill_replays"] != requests
            or prof["graph_launches"] != prof["replays"] + prof["prefill_replays"]):
        raise AssertionError(f"{model}: {prof['replays']} decode and {prof['prefill_replays']} "
                             f"prefill replays ({requests} requests) but "
                             f"{prof['graph_launches']} cudaGraphLaunch calls profiled")
    want = STEP_LAUNCHES.get(model)      # the bf16 models (tiny ones run f32 kernels)
    if want is not None and prof["launches"] != prof["launches_capture_x_replays"]:
        raise AssertionError(f"{model}: the profiler saw {prof['launches']} kernel launches in "
                             f"the replays, the captures record "
                             f"{prof['launches_capture_x_replays']}; windows before: {short}")
    if want is not None and prof["launches_per_step"] != {k: float(v) for k, v in want.items()}:
        raise AssertionError(f"{model}: {prof['launches_per_step']} kernel launches a decode "
                             f"step in the replays, want {want}")
    step_ms = [(r["seconds"] - r["ttftSeconds"]) / (new - 1) * 1e3 for r in results]
    SERVED_TOKENS[label or model] = [r["tokens"] for r in results]
    SERVED_PROMPTS[label or model] = prompts
    eng = cell.engine
    out = {
        "model": model, "requests": requests, "prompt_len": prompt_len, "new_tokens": new,
        **({"kv_page_tokens": eng.page_tokens, "kv_pool_pages": eng.kv_pool_pages,
            "view_bytes": stats["view_bytes"], "preemptions": eng.preemptions}
           if eng.paged else {}),
        **({"stream_stop": stopped} if stopped else {}),
        "boot_s": round(boot_s, 3), "draw_s": round(t_draw - t0, 3),
        "precompile_s": cell.boot_s["precompile"], "warmup_s": cell.boot_s["warmup"],
        "capture_s": round(stats["capture_s"], 3), "captures": stats["captures"],
        "programs": sorted(stats["launches_by_key"]),
        "pool_bytes": stats["pool_bytes"],
        "prefill": {"captures": pstats["captures"], "capture_s": round(pstats["capture_s"], 3),
                    "pool_bytes": pstats["pool_bytes"], "static_bytes": pstats["static_bytes"],
                    "programs": sorted(pstats["launches_by_key"]),
                    "replays_per_prefill": prof["prefill_replays"] / requests},
        "captures_after_warmup_in_traffic": {
            "decode": stats["captures_after_warmup"] - after_warmup[0],
            "prefill": pstats["captures_after_warmup"] - after_warmup[1]},
        "decode_tok_s": round(requests * new / wall, 2),
        "ttft_ms": sorted(round(r["ttftSeconds"] * 1e3, 2) for r in results),
        "ms_per_decode_step": round(statistics.median(step_ms), 3),
        "launches": prof["launches"], "launch_count_method": "profiler, in the replays",
        **({"profile_windows_retried": short} if short else {}),
        "repeat_identical": True, "readyz": ready,
        "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 2),
        "profile": prof,
    }
    if keep is not None:
        keep[label or model] = cell
    del cell
    gc.collect()
    torch.cuda.empty_cache()
    return out


_LABEL_RE = re.compile(r'([a-zA-Z0-9_]+)="((?:[^"\\]|\\.)*)"')


def parse_metrics(text: str) -> dict:
    """A /metrics body -> {(sample name, sorted label pairs): value}, its
    sample lines (comment lines skipped)."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        head, value = line.rsplit(" ", 1)
        name, _, labels = head.partition("{")
        out[(name, tuple(sorted(_LABEL_RE.findall(labels))))] = float(value)
    return out


def metric(m: dict, name: str, **labels) -> float:
    """One sample of a parsed scrape (0 when absent)."""
    return m.get((name, tuple(sorted((k, str(v)) for k, v in labels.items()))), 0.0)


def metric_sum(m: dict, name: str) -> float:
    """The sum of a family's samples over every label set."""
    return sum(v for (n, _labels), v in m.items() if n == name)


def scrape(base: str) -> tuple[dict, float]:
    """GET /metrics -> (its parsed samples, the request's ms)."""
    t0 = time.monotonic()
    with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
        if r.status != 200:
            raise AssertionError(f"/metrics answered {r.status}")
        text = r.read().decode()
    ms = (time.monotonic() - t0) * 1e3
    return parse_metrics(text), ms


def get_json(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


class Scraper(threading.Thread):
    """GET /metrics every ``every_s`` until stopped: each scrape's ms, and
    every failure (status, parse, connection) as a string."""

    def __init__(self, base: str, every_s: float = 0.01):
        super().__init__(daemon=True, name="metrics-scraper")
        self.base, self.every_s = base, every_s
        self.ms: list[float] = []
        self.failures: list[str] = []
        self._halt = threading.Event()

    def run(self):
        while not self._halt.wait(self.every_s):
            try:
                self.ms.append(scrape(self.base)[1])
            except Exception as e:  # noqa: BLE001 — recorded, gated by the phase
                self.failures.append(f"{type(e).__name__}: {e}")

    def stop(self):
        self._halt.set()


def wait_idle(eng) -> None:
    """Until the engine holds no request and no chunk in flight (so every
    program's end mark is settled)."""
    for _ in range(1000):
        if not eng._requests and eng._inflight is None:
            return
        time.sleep(0.01)
    raise AssertionError("the engine did not go idle")


SPAN_EVENTS = ["submitted", "admitted", "prefill_dispatched", "first_token", "finished"]


def serve_obs(cell, bps: float) -> dict:
    """The serving cell's instruments on ``serve``'s llama3-8b int8 cell
    (drawn and warmed there; no new model). (a) ``serve``'s prompts with a
    ``traceparent`` each, plus one stochastic request whose keys are
    captured at first use, while a thread scrapes /metrics every 10 ms and
    the CUDA runtime probe runs; (b) the greedy prompts again under
    torch.profiler. Gates: every scrape answers and parses; the requests,
    tokens and TTFT-count deltas equal what was sent; the compile counter
    moves by the captures of the stochastic request's keys alone; the
    decode dispatch counter by the replays the profiler saw; the program
    seconds cover the profiled device time; the decode bandwidth gauge
    within 20% of the bound over the timers' own ms a step, below 1; the
    peak-memory gauge equal to torch.cuda.max_memory_allocated; the
    request's span events and the timeline's trace ids; a profile capture
    on disk; the probe's ``ok``; each newly captured decode key's replay
    equal to its eager run bitwise."""
    import uuid

    from torch.profiler import ProfilerActivity, profile

    from kukeon_tpu_torch.runtime.devices import probe_cuda_runtime
    from kukeon_tpu_torch.runtime.serving_cell import serve

    if cell is None:                     # a phase subset without serve
        cell = make_cell("llama3-8b", 1024)
        cell.warmup(128)
    eng = cell.engine
    stats, pstats = eng.program_stats, eng.program_stats["prefill"]
    prompts = SERVED_PROMPTS.get("llama3-8b")
    if prompts is None:
        g = torch.Generator().manual_seed(7)
        prompts = [torch.randint(0, cell.cfg.vocab_size, (128,), generator=g).tolist()
                   for _ in range(4)]
    new = 32
    bound = sum(bound_ms(4, K, N, bps)[0] * n for K, N, n in SHAPES_8B.values())
    parent = uuid.uuid4().hex[:16]

    def traced(n: int) -> list:
        return [uuid.uuid4().hex for _ in range(n)]

    greedy = [{"promptTokens": p, "maxNewTokens": new} for p in prompts]
    stochastic = {"promptTokens": prompts[0], "maxNewTokens": new, "temperature": 0.8,
                  "topK": 40, "topP": 0.9}
    eng.start()
    server = serve(cell)
    cell.mark_ready()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    scraper = Scraper(base)
    probe: dict = {}

    def run_probe():
        t0 = time.monotonic()
        probe["verdict"] = probe_cuda_runtime(timeout_s=120)
        probe["s"] = round(time.monotonic() - t0, 3)

    try:
        # (a) traffic, a first-use capture, the scrape thread and the probe.
        m0, _ = scrape(base)
        keys0 = (set(eng._programs.keys()), set(eng._prefill_programs.keys()))
        caps0 = stats["captures"] + pstats["captures"]
        tids = traced(len(greedy) + 1)
        prober = threading.Thread(target=run_probe, daemon=True)
        scraper.start()
        prober.start()
        t0 = time.monotonic()
        res_a = post_bodies(base, greedy + [stochastic],
                            [f"00-{t}-{parent}-01" for t in tids])
        wall_a = time.monotonic() - t0
        prober.join(timeout=180)
        scraper.stop()
        scraper.join(timeout=60)
        wait_idle(eng)
        m1, _ = scrape(base)
        new_decode = sorted(set(eng._programs.keys()) - keys0[0])
        new_prefill = sorted(set(eng._prefill_programs.keys()) - keys0[1], key=str)
        caps1 = stats["captures"] + pstats["captures"]
        # (b) the greedy traffic again, profiled.
        tids_b = traced(len(greedy))
        before = (stats["replays"], pstats["replays"])
        m2, _ = scrape(base)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res_b = post_bodies(base, greedy, [f"00-{t}-{parent}-01" for t in tids_b])
            torch.cuda.synchronize()
        wait_idle(eng)
        m3, _ = scrape(base)
        # The raw events (the profiler's tables take long over ~40k kernels).
        events = prof.profiler.kineto_results.events()
        graph_launches = sum(e.name() == "cudaGraphLaunch" for e in events)
        device_s = sum(e.duration_ns() for e in events
                       if e.device_type() == torch.autograd.DeviceType.CUDA
                       and not e.name().startswith(("Memcpy", "Memset"))) / 1e9
        decode_replays = stats["replays"] - before[0]
        prefill_replays = pstats["replays"] - before[1]
        # Memory: the scrape, then the allocator's own peak, nothing in flight.
        m4, scrape_idle_ms = scrape(base)
        peak = torch.cuda.max_memory_allocated(eng.device)
        steps = stats["steps"]
        spans = {t: get_json(base + f"/v1/trace?trace_id={t}")["spans"] for t in tids}
        timeline = get_json(base + "/v1/timeline?n=512")
        # An on-demand profile while one request runs.
        t0 = time.monotonic()
        started = post(base + "/v1/profile", {"durationMs": 500})
        post(base + "/v1/generate", {"promptTokens": prompts[0], "maxNewTokens": 8})
        capture = None
        for _ in range(600):
            capture = next((c for c in get_json(base + "/v1/profile")["captures"]
                            if c["name"] == started["capture"]["name"]), None)
            if capture is not None and capture["state"] != "running":
                break
            time.sleep(0.05)
        profile_s = time.monotonic() - t0
        wait_idle(eng)
    finally:
        scraper.stop()
        server.shutdown()
        server.server_close()
        eng.stop()

    sent_a, sent_b = len(greedy) + 1, len(greedy)
    for label, res, n in (("a", res_a, sent_a), ("b", res_b, sent_b)):
        if len(res) != n or any(r is None or r["numTokens"] != new for r in res):
            raise AssertionError(f"window {label}: a request came back wrong: {res}")
    deltas = {}
    for label, ma, mb, n in (("a", m0, m1, sent_a), ("b", m2, m3, sent_b)):
        d = {"requests_ok": metric(mb, "kukeon_engine_requests_total", outcome="ok")
             - metric(ma, "kukeon_engine_requests_total", outcome="ok"),
             "tokens": metric(mb, "kukeon_engine_tokens_total")
             - metric(ma, "kukeon_engine_tokens_total"),
             "ttft_count": metric(mb, "kukeon_engine_ttft_seconds_count")
             - metric(ma, "kukeon_engine_ttft_seconds_count"),
             "compiles": metric_sum(mb, "kukeon_compiles_total")
             - metric_sum(ma, "kukeon_compiles_total")}
        if (d["requests_ok"], d["tokens"], d["ttft_count"]) != (n, n * new, n):
            raise AssertionError(f"window {label}: deltas {d}, sent {n} requests of {new} tokens")
        deltas[label] = d
    if scraper.failures or len(scraper.ms) < 10:
        raise AssertionError(f"/metrics under traffic: {len(scraper.ms)} scrapes, failures "
                             f"{scraper.failures[:5]}")
    if (not new_decode and not new_prefill) or not all(k[2] for k in new_decode) \
            or not all(k[-1] for k in new_prefill):
        raise AssertionError(f"first-use captures {new_decode} {new_prefill}: want the "
                             "stochastic request's keys, and only those")
    if deltas["a"]["compiles"] != caps1 - caps0 or deltas["b"]["compiles"] != 0:
        raise AssertionError(f"kukeon_compiles_total moved {deltas['a']['compiles']} and "
                             f"{deltas['b']['compiles']}; the captures {caps1 - caps0} and 0")
    d_dispatch = (metric(m3, "kukeon_program_dispatch_total", program="decode_chunk")
                  - metric(m2, "kukeon_program_dispatch_total", program="decode_chunk"))
    if not (d_dispatch == decode_replays == graph_launches - prefill_replays > 0) \
            or prefill_replays != sent_b:
        raise AssertionError(f"decode dispatches {d_dispatch}, replays {decode_replays}, "
                             f"profiled cudaGraphLaunch {graph_launches} with "
                             f"{prefill_replays} prefill replays")
    d_seconds = sum(v - m2.get(k, 0.0) for k, v in m3.items()
                    if k[0] == "kukeon_program_seconds_sum")
    if d_seconds < device_s:
        raise AssertionError(f"program seconds {d_seconds} under the profiled device time "
                             f"{device_s}")
    busy = metric(m4, "kukeon_program_seconds_sum", program="decode_chunk")
    settled = metric(m4, "kukeon_program_seconds_count", program="decode_chunk")
    dispatched = metric(m4, "kukeon_program_dispatch_total", program="decode_chunk")
    util = metric(m4, "kukeon_program_membw_util", program="decode_chunk")
    mfu = metric(m4, "kukeon_program_mfu", program="decode_chunk")
    timer_ms_step = busy * 1e3 / steps
    expected = bound / timer_ms_step
    if settled != dispatched or not (0.8 <= util / expected <= 1.2) or not 0 < util < 1:
        raise AssertionError(f"decode_chunk: membw_util {util} against {bound} ms / "
                             f"{timer_ms_step} ms a step = {expected} ({settled} of "
                             f"{dispatched} dispatches settled)")
    hbm_peak = metric(m4, "kukeon_hbm_bytes_peak", device=eng.device.index or 0)
    if hbm_peak != peak:
        raise AssertionError(f"kukeon_hbm_bytes_peak {hbm_peak}, max_memory_allocated {peak}")
    for t in tids:
        ss = spans[t]
        if len(ss) != 1 or ss[0].get("parentSpanId") != parent or ss[0]["outcome"] != "ok" \
                or [e["event"] for e in ss[0]["events"]] != SPAN_EVENTS:
            raise AssertionError(f"/v1/trace?trace_id={t}: {ss}")
    seen = {t for s in timeline["steps"] for t in s.get("traces", [])}
    if not set(tids) <= seen:
        raise AssertionError(f"/v1/timeline names {len(set(tids) & seen)} of the "
                             f"{len(tids)} traces")
    if capture is None or capture["state"] != "done" or not capture.get("sizeBytes"):
        raise AssertionError(f"POST /v1/profile: {capture}")
    shutil.rmtree(capture["path"], ignore_errors=True)
    if probe.get("verdict", ("none",))[0] != "ok":
        raise AssertionError(f"probe_cuda_runtime while serving: {probe}")
    # The keys captured mid-traffic: replay against eager, bitwise.
    with seated(cell):
        bitwise = [decode_replay_vs_eager(eng, key)["key"] for key in new_decode]
    ms = sorted(scraper.ms)
    return {
        "model": "llama3-8b", "requests": [sent_a, sent_b], "new_tokens": new,
        "wall_a_s": round(wall_a, 3), "deltas": deltas,
        "scrape_ms_under_traffic": {"n": len(ms), "median": round(statistics.median(ms), 3),
                                    "p95": round(ms[int(0.95 * (len(ms) - 1))], 3),
                                    "max": round(ms[-1], 3)},
        "scrape_ms_idle": round(scrape_idle_ms, 3),
        "captured_mid_traffic": {"decode": [list(k) for k in new_decode],
                                 "prefill": [list(k) for k in new_prefill]},
        "replay_equals_eager_bitwise": bitwise,
        "profiled": {"decode_replays": decode_replays, "prefill_replays": prefill_replays,
                     "cuda_graph_launches": graph_launches,
                     "dispatch_delta": d_dispatch, "program_seconds_delta": round(d_seconds, 6),
                     "device_s": round(device_s, 6)},
        "decode_chunk": {"membw_util": round(util, 6), "mfu": round(mfu, 6),
                         "timer_ms_per_step": round(timer_ms_step, 4),
                         "bound_ms_per_step": round(bound, 4),
                         "expected_membw_util": round(expected, 6),
                         "ratio": round(util / expected, 4), "steps": steps,
                         "dispatches": dispatched},
        "hbm_bytes_peak": hbm_peak,
        "hbm_bytes_in_use": metric(m4, "kukeon_hbm_bytes_in_use", device=eng.device.index or 0),
        "hbm_bytes_limit": metric(m4, "kukeon_hbm_bytes_limit", device=eng.device.index or 0),
        "span_events": SPAN_EVENTS, "timeline_steps": len(timeline["steps"]),
        "profile_capture": {"bytes": capture["sizeBytes"], "s": round(profile_s, 3)},
        "probe": {"verdict": list(probe["verdict"]), "s": probe["s"]},
    }


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits, for a bitwise comparison (floats as integers)."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def replay_timing(progs, key, runs: int = 3) -> dict:
    """One program's replay, each run from the same saved state: the host
    time of the replay call, CUDA events before and after it (device time,
    plus whatever of the launch the device waits for), and the kernels'
    own device time in one replay (torch.profiler), all ms; the program's
    graph nodes a step follow as kernels over steps."""
    from torch.profiler import ProfilerActivity, profile

    snap = progs.snapshot(key[0])
    host, dev = [], []
    for _ in range(runs):
        progs.restore(snap)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        t0 = time.monotonic()
        progs.run(key)
        host.append((time.monotonic() - t0) * 1e3)
        b.record()
        b.synchronize()
        dev.append(a.elapsed_time(b))
    progs.restore(snap)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        progs.run(key)
        torch.cuda.synchronize()
    progs.restore(snap)
    torch.cuda.synchronize()
    kernels = device_kernels(prof)
    k = key[0]
    return {"key": list(key), "replay_call_host_ms": round(statistics.median(host), 3),
            "replay_event_ms": round(statistics.median(dev), 3),
            "kernel_device_ms": round(sum(dev_us(e) for e in kernels) / 1e3, 3),
            "kernels_per_step": sum(e.count for e in kernels) / k,
            "event_ms_per_step": round(statistics.median(dev) / k, 3)}


def graph_decode_check(cell, prompt_len: int = 128) -> dict:
    """Replay against eager of one decode program on the same state: 4
    slots decoding 128-token prompts; the state is saved, the 4-step program
    replays, the state is put back, the same program runs op by op; the
    tokens, lengths and KV rows written must be bitwise equal. Greedy, and
    a stochastic key (temperature 0.8, top-k 40, top-p 0.9 in every slot)
    from the same generator state. The engine's state is left as found."""
    from kukeon_tpu_torch.serving.programs import program_key
    from kukeon_tpu_torch.serving.sampling import SamplingParams

    eng = cell.engine
    cell.warmup(prompt_len)
    with seated(cell, prompt_len):
        out = {label: decode_replay_vs_eager(eng, key)
               for label, key in (("greedy", program_key(4, False, False)),
                                  ("stochastic", program_key(4, True, True)))}
        with torch.no_grad():
            out["replay_16"] = replay_timing(eng._programs, program_key(16, False, False))
    return {**out, "captures": eng.program_stats["captures"],
            "capture_s": round(eng.program_stats["capture_s"], 3)}


@contextlib.contextmanager
def seated(cell, prompt_len: int = 128):
    """Every slot of ``cell``'s engine (its driver thread stopped) decoding
    a 128-token prompt, two chunks in; cancelled and drained after."""
    from kukeon_tpu_torch.serving.sampling import SamplingParams

    eng = cell.engine
    g = torch.Generator().manual_seed(11)
    reqs = [eng.submit(torch.randint(0, cell.cfg.vocab_size, (prompt_len,), generator=g).numpy(),
                       SamplingParams(max_new_tokens=256))
            for _ in range(eng.num_slots)]
    with torch.no_grad():
        eng.step()          # prefill + insert every slot, one chunk enqueued
        eng.step()          # a second chunk
        torch.cuda.synchronize()
    try:
        yield reqs
    finally:
        eng._sampling_dirty = True      # the next chunk uploads the slots' own arrays
        for r in reqs:
            r.cancel()
        while not all(r.done.is_set() for r in reqs):
            eng.step()
        torch.cuda.synchronize()


@torch.no_grad()
def decode_replay_vs_eager(eng, key) -> dict:
    """One decode program's replay against its eager run from one saved
    state (slots seated): the tokens, lengths and KV rows written must be
    bitwise equal. A stochastic key runs with temperature 0.8, top-k 40 and
    top-p 0.9 in every slot, both runs from the same generator state. The
    state is put back."""
    progs, st = eng._programs, eng.state
    k = key[0]
    if key[2]:
        st.temps.fill_(0.8)
        st.top_ks.fill_(40)
        st.top_ps.fill_(0.9)
    progs.build(key)
    snap = progs.snapshot(k)
    runs = {}
    for how in ("replay", "eager"):
        progs.restore(snap)
        if how == "replay":
            progs.run(key)
        else:
            progs.run_eager(key)
        torch.cuda.synchronize()
        runs[how] = {"tokens": progs.output(k).clone(), "lengths": st.cache.lengths.clone(),
                     **progs.written_rows(snap)}
    progs.restore(snap)
    diff = [n for n in runs["replay"]
            if not torch.equal(_bits(runs["replay"][n]), _bits(runs["eager"][n]))]
    if diff:
        raise AssertionError(f"program {key}: replay and eager differ in {diff}")
    advanced = runs["replay"]["lengths"] - snap["lengths"]
    if not torch.all(advanced == k):
        raise AssertionError(f"{key}: lengths advanced by {advanced.tolist()}, want {k}")
    return {"key": list(key), "bitwise_equal": ["tokens", "lengths", "k", "v"],
            "tokens": runs["replay"]["tokens"].tolist()}


def graph_prefill_check(cell) -> dict:
    """Replay against eager of the prefill programs (prefill, sampling and
    insert, one graph) on the same state: the inputs of a request are
    staged for slot 1, the state is saved, the program replays, the state
    is put back and the same program runs op by op; the first token, the
    slot's K and V rows, its length, token and active, the KV block and
    the generator state must be bitwise equal. At bucket 128 greedy and
    with a stochastic key (temperature 0.8, top-k 40, top-p 0.9), and a
    ``prefill_ext`` at (Pb 512, S_tail 64) over a stored 400-token prefix.
    Then a prefix hit's first-token logits against a full prefill of the
    same prompt (``logits_agree``). The engine's state is left as found."""
    from kukeon_tpu_torch.serving.engine import Request
    from kukeon_tpu_torch.serving.sampling import SamplingParams

    eng = cell.engine
    cell.warmup(128)
    progs = eng._prefill_programs
    g = torch.Generator().manual_seed(13)

    def prompt(n):
        return torch.randint(0, cell.cfg.vocab_size, (n,), generator=g).numpy().astype(np.int32)

    stored, tail = prompt(400), prompt(50)
    seed = eng.submit(stored, SamplingParams(max_new_tokens=1), prefix_id="graph-prefill")
    while not seed.done.is_set():
        eng.step()
    grown = np.concatenate([stored, tail])
    cases = (("bucket 128 greedy", Request(-1, prompt(100), SamplingParams())),
             ("bucket 128 stochastic", Request(-2, prompt(100), SamplingParams(
                 temperature=0.8, top_k=40, top_p=0.9))),
             ("prefill_ext 512 + 64", Request(-3, grown, SamplingParams(),
                                              prefix_id="graph-prefill")))
    out = {}
    with torch.no_grad():
        for label, req in cases:
            key = eng._stage_prefill(req, 1)
            t0 = time.monotonic()
            progs.build(key)
            build_s = time.monotonic() - t0
            snap = progs.snapshot_key(key)
            runs = {}
            for how in ("replay", "eager"):
                progs.restore(snap)
                if how == "replay":
                    progs.run(key)
                else:
                    progs.run_eager(key)
                torch.cuda.synchronize()
                runs[how] = progs.snapshot_key(key)
            progs.restore(snap)
            a, b = runs["replay"], runs["eager"]
            flat = {n: (a[n], b[n]) for n in ("lengths", "tokens", "active", "block_k",
                                               "block_v", "gen")}
            flat.update({f"kv_{n}": (a["kv"][n], b["kv"][n]) for n in a["kv"]})
            diff = [n for n, (x, y) in flat.items() if not torch.equal(_bits(x), _bits(y))]
            if diff:
                raise AssertionError(f"{label} {key}: replay and eager differ in {diff}")
            if int(a["lengths"][1]) != req.prompt.size or not bool(a["active"][1]):
                raise AssertionError(f"{label}: slot 1 length {int(a['lengths'][1])}, "
                                     f"active {bool(a['active'][1])}")
            out[label] = {"key": list(key), "bitwise_equal": sorted(flat),
                          "first_token": int(a["tokens"][1]), "build_s": round(build_s, 3),
                          "launches_at_capture": progs.stats["launches_by_key"][str(key)]}
        logits = {}
        for label, pid in (("hit", "graph-prefill"), ("full", None)):
            key = eng._stage_prefill(Request(-4, grown, SamplingParams(), prefix_id=pid), 1)
            snap = progs.snapshot_key(key)
            logits[label] = progs.logits(key).float()
            progs.restore(snap)
            out[f"{label}_key"] = list(key)
        torch.cuda.synchronize()
    out["hit_vs_full_logits"] = logits_agree(logits["hit"], logits["full"],
                                             "prefix hit vs full prefill")
    out["tolerance"] = "replay vs eager bitwise; hit vs full: logits_agree (cosine >= 0.999)"
    st = progs.stats
    return {**out, "prefill_captures": st["captures"], "capture_s": round(st["capture_s"], 3),
            "pool_bytes": st["pool_bytes"], "static_bytes": st["static_bytes"]}


def _paged_engine(cell, kv_cache_int8: bool):
    from kukeon_tpu_torch.serving.engine import ServingEngine

    return ServingEngine(cell.cfg, cell.engine.params, num_slots=4, max_seq_len=1024,
                         device="cuda", kv_page_tokens=64, kv_cache_int8=kv_cache_int8)


def _kept(t: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The pages [L, n, ...] of ``t`` whose ids are not scratch (page 0
    takes duplicate stray writes in no fixed order)."""
    return t[:, (ids != 0).cpu()]


def graph_paged_prefill(eng, g: torch.Generator, kv8: bool) -> dict:
    """Paged prefill programs, replay against eager from one saved state,
    staged for slot 1 into pages taken from the pool: at bucket 128
    (greedy and, bf16 KV, stochastic) and a ``prefill_ext_paged`` over the
    shared pages of a stored 400-token prefix (Pb 512, S 128)."""
    from kukeon_tpu_torch.serving.engine import Request
    from kukeon_tpu_torch.serving.sampling import SamplingParams

    progs = eng._prefill_programs

    def prompt(n):
        return torch.randint(0, eng.cfg.vocab_size, (n,), generator=g).numpy().astype(np.int32)

    stored, tail = prompt(400), prompt(50)
    seed = eng.submit(stored, SamplingParams(max_new_tokens=1), prefix_id="graph-paged")
    while not seed.done.is_set():
        eng.step()
    cases = [("prefill_paged 128 greedy", Request(-1, prompt(100), SamplingParams())),
             ("prefill_ext_paged 512 + 128", Request(-3, np.concatenate([stored, tail]),
                                                     SamplingParams(), prefix_id="graph-paged"))]
    if not kv8:
        cases.insert(1, ("prefill_paged 128 stochastic", Request(-2, prompt(100), SamplingParams(
            temperature=0.8, top_k=40, top_p=0.9))))
    out = {}
    with torch.no_grad():
        for label, req in cases:
            cached = eng._prefix_lookup_paged(req, req.prompt)
            shared = list(cached.pages) if cached is not None else []
            priv = eng._pool.alloc(req.prompt.size // eng.page_tokens + 1 - len(shared))
            key = eng._stage_prefill_paged(req, 1, req.prompt, cached, shared + priv)
            t0 = time.monotonic()
            progs.build(key)
            build_s = time.monotonic() - t0
            snap = progs.snapshot_key(key)
            runs = {}
            for how in ("replay", "eager"):
                progs.restore(snap)
                if how == "replay":
                    progs.run(key)
                else:
                    progs.run_eager(key)
                torch.cuda.synchronize()
                runs[how] = progs.snapshot_key(key)
            progs.restore(snap)
            eng._pool.unref(priv)
            a, b = runs["replay"], runs["eager"]
            flat = {n: (a[n], b[n]) for n in ("lengths", "tokens", "active", "block_k",
                                               "block_v", "gen")}
            flat.update({f"pool_{n}": (_kept(a["kv"][n], a["ids"]), _kept(b["kv"][n], a["ids"]))
                         for n in a["kv"]})
            diff = [n for n, (x, y) in flat.items() if not torch.equal(_bits(x), _bits(y))]
            if diff:
                raise AssertionError(f"{label} {key}: replay and eager differ in {diff}")
            if int(a["lengths"][1]) != req.prompt.size or not bool(a["active"][1]):
                raise AssertionError(f"{label}: slot 1 length {int(a['lengths'][1])}")
            written = int((a["ids"] != 0).sum())
            if written != -(-req.prompt.size // eng.page_tokens) - len(shared):
                raise AssertionError(f"{label}: {written} pages written, shared {len(shared)}")
            out[label] = {"key": list(key), "bitwise_equal": sorted(flat),
                          "pages_written": written, "pages_shared": len(shared),
                          "first_token": int(a["tokens"][1]), "build_s": round(build_s, 3)}
    return out


def graph_paged_decode(eng, g: torch.Generator, kv8: bool) -> dict:
    """Paged decode programs, replay against eager from one saved state: 4
    slots decoding 128-token prompts, the 4-step program greedy and (bf16
    KV) stochastic; tokens, lengths, the block table, the pool rows the
    chunk scatters to (page 0 aside) and the generator state bitwise
    equal. Then a 16-step replay timed."""
    from kukeon_tpu_torch.serving.programs import program_key
    from kukeon_tpu_torch.serving.sampling import SamplingParams

    reqs = [eng.submit(torch.randint(0, eng.cfg.vocab_size, (128,), generator=g).numpy(),
                       SamplingParams(max_new_tokens=256))
            for _ in range(eng.num_slots)]
    out = {}
    with torch.no_grad():
        eng.step()
        eng.step()
        torch.cuda.synchronize()
        progs, st = eng._programs, eng.state
        keys = [("greedy", program_key(4, False, False))]
        if not kv8:
            keys.append(("stochastic", program_key(4, True, True)))
        for label, key in keys:
            if key[2]:
                st.temps.fill_(0.8)
                st.top_ks.fill_(40)
                st.top_ps.fill_(0.9)
            progs.build(key)
            snap = progs.snapshot(4)
            runs = {}
            for how in ("replay", "eager"):
                progs.restore(snap)
                if how == "replay":
                    progs.run(key)
                else:
                    progs.run_eager(key)
                torch.cuda.synchronize()
                runs[how] = {"tokens": progs.output(4).clone(), "bt": st.bt.clone(),
                             "lengths": st.cache.lengths.clone(),
                             "gen": eng._gen.get_state(), **progs.written_rows(snap)}
            progs.restore(snap)
            diff = [n for n in runs["replay"]
                    if not torch.equal(_bits(runs["replay"][n]), _bits(runs["eager"][n]))]
            if diff:
                raise AssertionError(f"paged {label} {key}: replay and eager differ in {diff}")
            if not torch.all(runs["replay"]["lengths"] - snap["lengths"] == 4):
                raise AssertionError(f"paged {label}: lengths did not advance by 4")
            out[label] = {"key": list(key), "bitwise_equal": sorted(runs["replay"]),
                          "pool_rows_compared": int(runs["replay"]["k"].shape[1])}
        out["replay_16"] = replay_timing(progs, program_key(16, False, False))
        eng._sampling_dirty = True
    for r in reqs:
        r.cancel()
    while not all(r.done.is_set() for r in reqs):
        eng.step()
    torch.cuda.synchronize()
    return out


def graph_paged_check(cell) -> dict:
    """llama3-8b int8 over ``cell``'s weights, kv_page_tokens 64, 4 slots,
    max_seq_len 1024: the paged prefill and decode programs' replays
    against their eager runs, bf16 KV and int8 KV; the graph pools and
    the dense view's bytes."""
    out = {}
    for label, kv8 in (("bf16_kv", False), ("int8_kv", True)):
        eng = _paged_engine(cell, kv8)
        t0 = time.monotonic()
        eng.precompile((128,))
        eng.warmup(128)
        g = torch.Generator().manual_seed(19)
        st = eng.program_stats
        out[label] = {"precompile_warmup_s": round(time.monotonic() - t0, 3),
                      "prefill": graph_paged_prefill(eng, g, kv8),
                      "decode": graph_paged_decode(eng, g, kv8),
                      "pool_pages": eng.kv_pool_pages, "view_bytes": st["view_bytes"],
                      "decode_pool_bytes": st["pool_bytes"],
                      "prefill_pool_bytes": st["prefill"]["pool_bytes"],
                      "decode_captures": st["captures"],
                      "prefill_captures": st["prefill"]["captures"]}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    out["tolerance"] = "replay vs eager bitwise (page 0 aside)"
    return out


# serve_paged (b): the reference's paged arm (bench.py:340-400): 24 agent
# requests on one 256-token prefix, tails alternating 32 and 384 tokens,
# 64 and 128 greedy tokens; a legacy arm at 4 slots and a paged arm at 12
# slots whose 64 pages of 64 rows hold the legacy arm's 4 x 1024 rows. At
# 12 slots this traffic peaks at 63 of the 64 pages and never preempts (in
# the reference's engine too: tests/test_torch_engine_paged.py), so a
# third arm seats 16 slots on the same pool, where it must.
ARM_PREFIX, ARM_TAILS, ARM_NEW, ARM_REQUESTS = 256, (32, 384), (64, 128), 24
ARM_SLOTS, ARM_PAGE, ARM_POOL = {"legacy": 4, "paged": 12, "paged_16": 16}, 64, 64


def run_arm(cfg, params, arm: str, workload: list) -> dict:
    """One arm through the engine, stepped here: the workload once to
    capture every key it takes (the prefix cache emptied after), then
    measured. Tokens/s over the measured pass, TTFT p50/p95 from submit,
    inter-token ms (median over requests), wall ms a decode step (the
    prefills' time included), the 16-step decode program's ms a step
    alone (CUDA events and its kernels' device time), prefix hits,
    preemptions, peak pages in use, pool and view bytes."""
    from kukeon_tpu_torch.serving.engine import ServingEngine
    from kukeon_tpu_torch.serving.programs import program_key
    from kukeon_tpu_torch.serving.sampling import SamplingParams

    paged = arm.startswith("paged")
    eng = ServingEngine(cfg, params, num_slots=ARM_SLOTS[arm], max_seq_len=1024,
                        device="cuda", kv_page_tokens=ARM_PAGE if paged else 0,
                        kv_pool_pages=ARM_POOL if paged else None)
    t0 = time.monotonic()
    eng.precompile(tuple(ARM_PREFIX + t for t in ARM_TAILS))
    eng.warmup(ARM_PREFIX + ARM_TAILS[0])
    boot_s = time.monotonic() - t0

    def one_pass():
        reqs = [eng.submit(p, SamplingParams(max_new_tokens=n), prefix_id="agent")
                for p, n in workload]
        peak, seated = 0, 0
        t0 = time.monotonic()
        with torch.no_grad():
            while not all(r.done.is_set() for r in reqs):
                eng.step()
                peak = max(peak, eng._pool.in_use if paged else 0)
                seated = max(seated, sum(r is not None for r in eng._slot_req))
        torch.cuda.synchronize()
        return reqs, time.monotonic() - t0, peak, seated

    warm, _, _, _ = one_pass()
    if paged:
        eng._reclaim_prefix_pages(eng._pool.num_pages)
    else:
        eng._prefix_cache.clear()
    st, pst = eng.program_stats, eng.program_stats["prefill"]
    before = {"captures": (st["captures"], pst["captures"]), "steps": st["steps"],
              "hits": eng.prefix_hits, "misses": eng.prefix_misses,
              "preemptions": eng.preemptions}
    reqs, wall, peak, seated = one_pass()
    captures = (st["captures"], pst["captures"])
    bad = [(i, r.error, len(r.generated)) for i, (r, (_, n)) in enumerate(zip(reqs, workload))
           if r.error is not None or len(r.generated) != n]
    if bad:
        raise AssertionError(f"{arm} arm: requests came back short or failed: {bad}")
    if captures != before["captures"]:
        raise AssertionError(f"{arm} arm: (decode, prefill) captures {before['captures']} -> "
                             f"{captures} in the measured pass")
    if [r.generated for r in reqs] != [r.generated for r in warm]:
        raise AssertionError(f"{arm} arm: the two passes gave different tokens")
    ttft = sorted((r.first_token_at - r.submitted_at) * 1e3 for r in reqs)
    itl = [(r.last_token_at - r.first_token_at) / (len(r.generated) - 1) * 1e3 for r in reqs]
    steps = st["steps"] - before["steps"]
    tokens = sum(len(r.generated) for r in reqs)
    # The arm's decode step alone: its 16-step program replayed on the
    # idle engine (every slot's rows run, seated or not).
    with torch.no_grad():
        step = replay_timing(eng._programs, program_key(16, False, False))
    out = {"slots": ARM_SLOTS[arm], "kv_rows": (ARM_POOL * ARM_PAGE if paged
                                                else ARM_SLOTS[arm] * 1024),
           "boot_s": round(boot_s, 3), "wall_s": round(wall, 3), "tokens": tokens,
           "tok_per_s": round(tokens / wall, 2),
           "ttft_ms_p50": round(statistics.median(ttft), 2),
           "ttft_ms_p95": round(ttft[min(len(ttft) - 1, math.ceil(0.95 * len(ttft)) - 1)], 2),
           "itl_ms_median": round(statistics.median(itl), 3),
           "decode_steps": steps, "wall_ms_per_decode_step": round(wall * 1e3 / steps, 3),
           "replay_event_ms_per_step": step["event_ms_per_step"],
           "replay_kernel_device_ms_per_step": round(step["kernel_device_ms"] / 16, 3),
           "max_seated": seated,
           "prefix_hits": eng.prefix_hits - before["hits"],
           "prefix_misses": eng.prefix_misses - before["misses"],
           "preemptions": eng.preemptions - before["preemptions"],
           "preempted_requests": sum(r.preemptions > 0 for r in reqs),
           "peak_pages_in_use": peak,
           "decode_pool_bytes": st["pool_bytes"], "prefill_pool_bytes": pst["pool_bytes"],
           "view_bytes": st["view_bytes"], "prefill_keys": sorted(pst["launches_by_key"]),
           "captures": list(captures)}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_paged(k1) -> dict:
    """llama3-8b int8, max_seq_len 1024, the paged KV layout (pages of 64
    rows). (a) The port's ServingCell with kv_page_tokens 64 and 4 slots
    over HTTP takes the ``serve`` phase's 4 prompts: its greedy tokens
    equal the legacy cell's, 225 K1 launches a decode step inside the
    replays, no capture in the traffic. (b) The reference's paged arm
    (ARM_*) through the engine, the legacy arm, then the paged arms at 12
    and 16 slots, on the same weights: every request completes with its
    full count, the 16-slot arm preempts, no capture in the measured
    pass."""
    if "llama3-8b" not in SERVED_TOKENS:
        raise AssertionError("serve_paged compares with the serve phase's tokens: run serve")
    cell = make_cell("llama3-8b", 1024, kv_page_tokens=64)
    a = serve_model(k1, "llama3-8b", max_seq_len=1024, prompt_len=128, new=64,
                    profile_new=32, cell=cell, label="llama3-8b paged")
    if SERVED_TOKENS["llama3-8b paged"] != SERVED_TOKENS["llama3-8b"]:
        raise AssertionError("paged layout: greedy tokens differ from the legacy cell's")
    cfg, params = cell.cfg, cell.engine.params
    del cell
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(7)
    prefix = rng.integers(1, cfg.vocab_size, ARM_PREFIX).astype(np.int32)
    workload = [(np.concatenate([prefix, rng.integers(1, cfg.vocab_size, ARM_TAILS[i % 2])
                                 .astype(np.int32)]), ARM_NEW[i % 2])
                for i in range(ARM_REQUESTS)]
    arms = {arm: run_arm(cfg, params, arm, workload) for arm in ARM_SLOTS}
    if arms["paged_16"]["preemptions"] <= 0:
        raise AssertionError(f"the 16-slot paged arm never preempted: {arms['paged_16']}")
    return {"layout_check": {k: a[k] for k in (
                "kv_page_tokens", "kv_pool_pages", "view_bytes", "ttft_ms",
                "ms_per_decode_step", "decode_tok_s", "launches", "pool_bytes", "prefill",
                "captures_after_warmup_in_traffic", "peak_mem_gb")},
            "layout_check_tokens_equal_legacy": True,
            "layout_check_launches_per_step": a["profile"]["launches_per_step"],
            "layout_check_device_idle_share": a["profile"]["device_idle_share"],
            "arms": arms,
            "workload": {"requests": ARM_REQUESTS, "prefix": ARM_PREFIX, "tails": ARM_TAILS,
                         "new_tokens": ARM_NEW, "page_tokens": ARM_PAGE,
                         "slots": ARM_SLOTS, "pool_pages": ARM_POOL,
                         "source": "bench.py:340-400"}}


# serve_disagg: the KV handoff between a prefill cell and a decode cell,
# both hops driven as the reference's gateway drives them
# (kukeon_tpu/gateway/cell.py:465-600). KV bytes a prompt token moves:
# L 32 x (K, V) x KV 8 x D 128 x bf16, for llama3-8b and Mixtral alike.
KV_BYTES_PER_TOKEN = 131072
# (b): the reference's disagg arm (bench.py:505-521) at 8B: sessions on one
# prefixId, a shared prefix, tails and greedy budgets alternating; an arm's
# decode side has 8 slots on a 64-page pool of 64 rows.
DISAGG_SESSIONS, DISAGG_PREFIX, DISAGG_TAILS, DISAGG_NEW = 16, 256, (32, 128), (16, 64)
DISAGG_SLOTS, DISAGG_PAGE, DISAGG_POOL = 8, 64, 64


def engine_handoff(src, dst, prompt: list, want: list) -> dict:
    """One KV handoff between two engines, stepped here: ``src`` exports
    ``prompt`` (its prefill alone), ``dst`` imports the payload; the
    greedy tokens must be ``want`` and the rows KV_BYTES_PER_TOKEN a
    token."""
    from kukeon_tpu_torch.serving.sampling import SamplingParams

    sp = SamplingParams(max_new_tokens=len(want))
    prompt = np.asarray(prompt, np.int32)
    # The export and insert-only programs of the prompt's bucket, captured
    # first, as a prefill and a decode cell's warmup would.
    tc = time.monotonic()
    src.precompile((prompt.size,), export=True)
    dst.precompile((prompt.size,), imports=True)
    t0 = time.monotonic()
    r = src.submit(prompt, sp, export=True)
    while not r.done.is_set():
        src.step()
    export_s = time.monotonic() - t0
    if r.error is not None:
        raise AssertionError(f"export failed: {r.error}")
    p = r.export_payload
    nbytes = sum(t.numel() * t.element_size() for t in (p["k"], p["v"]))
    if nbytes != KV_BYTES_PER_TOKEN * prompt.size or p["k"].dtype != torch.bfloat16:
        raise AssertionError(f"export of {prompt.size} tokens: {nbytes} bytes of "
                             f"{p['k'].dtype}, want {KV_BYTES_PER_TOKEN} a token in bf16")
    t1 = time.monotonic()
    r2 = dst.submit(prompt, sp, kv_import={k: p[k] for k in ("token", "length", "k", "v")})
    while not r2.done.is_set():
        dst.step()
    while dst.step():                    # the chunk still in flight
        pass
    if r2.error is not None or r2.generated != want:
        raise AssertionError(f"handoff: {r2.error or r2.generated} against {want}")
    return {"prompt_len": int(prompt.size), "tokens": len(want), "tokens_equal": True,
            "kv_bytes": nbytes, "capture_s": round(t0 - tc, 3),
            "wall_s": round(time.monotonic() - tc, 3), "export_ms": round(export_s * 1e3, 2),
            "import_to_first_token_ms": round((r2.first_token_at - t1) * 1e3, 2),
            "importer_prefill_keys": sorted(dst.program_stats["prefill"]["launches_by_key"])}


def post_bytes(url: str, body: bytes) -> bytes:
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.read()


def http_handoff(prefill: str, decode: str, body: dict, stream: bool) -> dict:
    """Both hops of one request over HTTP, as the reference's gateway
    drives them: ``/v1/kv/export`` on the prefill cell, then its header
    (plus ``stream``) and raw rows to the decode cell's ``/v1/kv/import``.
    -> the tokens, the export's header and wire bytes, and client times:
    the export, the import to its first line, and start to first line."""
    t0 = time.monotonic()
    data = post_bytes(prefill + "/v1/kv/export", json.dumps(body).encode())
    t1 = time.monotonic()
    nl = data.find(b"\n")
    header = json.loads(data[:nl])
    if header.get("done"):
        raise AssertionError(f"an export's first token ended the request: {header}")
    imp = urllib.request.Request(
        decode + "/v1/kv/import", data=json.dumps({**header, "stream": stream}).encode()
        + data[nl:], headers={"Content-Type": "application/x-kukeon-kv"})
    with urllib.request.urlopen(imp, timeout=600) as r:
        first = r.readline()
        t2 = time.monotonic()
        rest = r.read()
    if stream:
        recs = [json.loads(x) for x in (first + rest).splitlines() if x.strip()]
        tokens = [x["token"] for x in recs if "token" in x]
        if not recs[-1].get("done") or recs[-1]["tokens"] != tokens:
            raise AssertionError(f"an import stream ended {recs[-1]}")
    else:
        tokens = json.loads(first + rest)["tokens"]
    return {"tokens": tokens, "header": header, "wire_bytes": len(data) - nl - 1,
            "export_s": t1 - t0, "import_first_s": t2 - t1, "ttft_s": t2 - t0}


def stream_generate(base: str, body: dict) -> dict:
    """A streamed ``/v1/generate`` -> its tokens and the time to its first
    line (the client's TTFT)."""
    req = urllib.request.Request(base + "/v1/generate",
                                 data=json.dumps({**body, "stream": True}).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=600) as r:
        first = r.readline()
        ttft = time.monotonic() - t0
        rest = r.read()
    recs = [json.loads(x) for x in (first + rest).splitlines() if x.strip()]
    if not recs[-1].get("done"):
        raise AssertionError(f"a stream ended {recs[-1]}")
    return {"tokens": recs[-1]["tokens"], "ttft_s": ttft}


def concurrently(fn, n: int, first_alone: bool = False) -> tuple[list, float]:
    """``fn(i)`` for i < n on threads -> (results, wall s). ``first_alone``:
    request 0 runs until its first line (it opens the shared context), then
    the others start together."""
    results, errors = [None] * n, []
    opened = threading.Event()

    def run(i):
        try:
            results[i] = fn(i, opened)
        except Exception as e:  # noqa: BLE001 — raised below, in the caller
            errors.append(e)
            opened.set()

    t0 = time.monotonic()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    threads[0].start()
    if first_alone:
        opened.wait(600)
    for t in threads[1:]:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors:
        raise errors[0]
    return results, time.monotonic() - t0


def serve_cells(cells: list, prompt_len: int) -> list:
    """Warm each cell (its role's programs captured; a cell warmed before
    only captures its role's keys for ``prompt_len``), start its engine and
    HTTP server -> the servers."""
    from kukeon_tpu_torch.runtime.serving_cell import serve

    servers = []
    for c in cells:
        if c.boot_s:
            c.engine.precompile((prompt_len,), export=c.role == "prefill",
                                imports=c.role == "decode")
        else:
            c.warmup(prompt_len)
        c.engine.start()
        servers.append(serve(c))
        c.mark_ready()
    return servers


def stop_cells(cells: list, servers: list) -> None:
    for srv in servers:
        srv.shutdown()
        srv.server_close()
    for c in cells:
        c.engine.stop()


def captures(cells: list) -> list:
    return [(c.engine.program_stats["captures"], c.engine.program_stats["prefill"]["captures"])
            for c in cells]


def launches_by_capture(cells: list, before: list) -> dict:
    """Each kernel's launches the cells' programs recorded at capture,
    times their replays since ``before`` (each cell's replays_by_key of
    its decode and prefill programs)."""
    out = {k: 0 for k in COUNTERS}
    for c, b in zip(cells, before):
        for stats, seen in ((c.engine.program_stats, b[0]),
                            (c.engine.program_stats["prefill"], b[1])):
            for key, n in stats["replays_by_key"].items():
                for k, name in COUNTERS.items():
                    out[k] += (n - seen.get(key, 0)) * stats["launches_by_key"][key][name]
    return out


def replays_now(cells: list) -> list:
    return [(dict(c.engine.program_stats["replays_by_key"]),
             dict(c.engine.program_stats["prefill"]["replays_by_key"])) for c in cells]


def disagg_parity(k1, pre) -> dict:
    """(a) llama3-8b int8, the ``serve`` phase's weights (``pre``, a legacy
    ``prefill`` cell drawn again from its seed) and its 4 prompts: ``pre``
    exports, a legacy and a paged ``decode`` cell (pages of 64) on the same
    weights import, half the requests streamed; every answer is
    ``serve``'s greedy tokens, every export carries KV_BYTES_PER_TOKEN a
    prompt token, no program is captured in the traffic; then a profiled
    two-token handoff into each decode cell, whose replays must launch K1
    as their captures record."""
    from torch.profiler import ProfilerActivity, profile

    prompts, want = SERVED_PROMPTS["llama3-8b"], SERVED_TOKENS["llama3-8b"]
    new = len(want[0])
    t0 = time.monotonic()
    decode = {"legacy": twin_cell(pre, 0, role="decode"),
              "paged": twin_cell(pre, DISAGG_PAGE, role="decode")}
    cells = [pre, *decode.values()]
    servers = serve_cells(cells, len(prompts[0]))
    boot_s = time.monotonic() - t0
    base = dict(zip(("prefill", "legacy", "paged"),
                    (f"http://127.0.0.1:{s.server_address[1]}" for s in servers)))
    try:
        before = captures(cells)
        # Every prompt into both decode cells at once, odd ones streamed.
        jobs = [(layout, i) for layout in decode for i in range(len(prompts))]
        res, wall = concurrently(lambda j, _o: http_handoff(
            base["prefill"], base[jobs[j][0]],
            {"promptTokens": prompts[jobs[j][1]], "maxNewTokens": new}, jobs[j][1] % 2 == 1),
            len(jobs))
        rounds = {"wall_s": round(wall, 3)}
        for (layout, i), r in zip(jobs, res):
            if r["tokens"] != want[i]:
                raise AssertionError(f"handoff into the {layout} cell (stream {i % 2}), "
                                     f"prompt {i}: {r['tokens']} against serve's {want[i]}")
            n, h = len(prompts[i]), r["header"]
            if (h["kBytes"] + h["vBytes"] != KV_BYTES_PER_TOKEN * n
                    or r["wire_bytes"] != KV_BYTES_PER_TOKEN * n
                    or h["dtype"] != "bfloat16" or h["length"] != n):
                raise AssertionError(f"export of {n} tokens: {h}")
            got = rounds.setdefault(layout, {"export_ms": [], "ndjson_import_first_line_ms": [],
                                             "ndjson_ttft_ms": []})
            got["export_ms"].append(round(r["export_s"] * 1e3, 2))
            if i % 2:
                got["ndjson_import_first_line_ms"].append(round(r["import_first_s"] * 1e3, 2))
                got["ndjson_ttft_ms"].append(round(r["ttft_s"] * 1e3, 2))
        # Each prompt alone, into the paged cell: one handoff's own costs.
        alone = [http_handoff(base["prefill"], base["paged"],
                              {"promptTokens": p, "maxNewTokens": 2}, True) for p in prompts]
        if [r["tokens"] for r in alone] != [w[:2] for w in want]:
            raise AssertionError(f"handoffs alone: {[r['tokens'] for r in alone]}")
        rounds["alone_into_paged"] = {
            key: [round(r[f] * 1e3, 2) for r in alone]
            for key, f in (("export_ms", "export_s"), ("import_first_line_ms", "import_first_s"),
                           ("ttft_ms", "ttft_s"))}
        if captures(cells) != before:
            raise AssertionError(f"(decode, prefill) captures by cell {before} -> "
                                 f"{captures(cells)} in the handoff traffic")
        # The profiled window: a two-token handoff into each decode cell
        # (two 16-step chunks each: the one that emits, and the one behind).
        k1.int8_matmul.launches = k1.int8_matmul.launches_t = 0
        k1.int8_matmul_expert.launches = 0

        def quiesce():
            # No chunk in flight and the device drained: a replay is then
            # wholly inside the window or wholly outside it.
            for c in cells:
                wait_idle(c.engine)
            torch.cuda.synchronize()

        def window():
            quiesce()
            seen0 = replays_now(cells)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                short = [http_handoff(base["prefill"], base[layout],
                                      {"promptTokens": prompts[0], "maxNewTokens": 2}, True)
                         for layout in decode]
                quiesce()
            # The raw events' names (the profiler's own tables take tens of
            # seconds to build over ~150,000 kernels).
            names = [e.name() for e in prof.profiler.kineto_results.events()]
            now = replays_now(cells)
            return {"short": short, "expect": launches_by_capture(cells, seen0),
                    "replays": sum(sum(n.values()) - sum(b.values())
                                   for c0, c1 in zip(seen0, now) for b, n in zip(c0, c1)),
                    "graph_launches": names.count("cudaGraphLaunch"),
                    "seen": {k: sum(kernel in n for n in names)
                             for k, kernel in KERNEL_NAMES.items()}}

        def dropped(w) -> bool:
            # Every replay's graph launch was seen, yet kernel records are
            # missing: a replay of a captured graph cannot launch fewer
            # kernels than its capture, so the profiler lost them (seen once
            # on Mixtral in serve_model, and on a 64-step window here).
            return (w["seen"] != w["expect"] and w["graph_launches"] == w["replays"]
                    and all(w["seen"][k] <= w["expect"][k] for k in w["seen"]))

        t1 = time.monotonic()
        w = window()
        retried = []
        while dropped(w) and len(retried) < 2:
            # The same traffic again, and the new window is held to the
            # same gate; every window's counts are reported.
            retried.append({k: w[k] for k in ("seen", "expect", "replays", "graph_launches")})
            w = window()
        profile_s = time.monotonic() - t1
        short, seen, expect = w["short"], w["seen"], w["expect"]
        outside = {"k1": k1.int8_matmul.launches - k1.int8_matmul.launches_t,
                   "k1t": k1.int8_matmul.launches_t, "k2": k1.int8_matmul_expert.launches}
        keys = {name: sorted(c.engine.program_stats["prefill"]["launches_by_key"])
                for name, c in zip(base, cells)}
    finally:
        stop_cells(cells, servers)
    if any(r["tokens"] != want[0][:2] for r in short):
        raise AssertionError(f"profiled handoffs: {[r['tokens'] for r in short]}")
    if seen["k1"] <= 0 or seen != expect or any(outside.values()):
        raise AssertionError(f"decode cells' replays: the profiler saw {seen} launches, the "
                             f"captures record {expect}; wrapper counts {outside}; "
                             f"{w['graph_launches']} graph launches profiled for "
                             f"{w['replays']} replays; windows before: {retried}")
    del decode, cells
    gc.collect()
    torch.cuda.empty_cache()
    return {"boot_s": round(boot_s, 3), "prompts": len(prompts), "prompt_len": len(prompts[0]),
            "new_tokens": new, "tokens_equal_serve": True,
            "kv_bytes_per_token": KV_BYTES_PER_TOKEN, "rounds": rounds,
            "launches": seen, "launch_count_method": "profiler, in the replays",
            "graph_launches": w["graph_launches"],
            **({"profile_windows_retried": retried} if retried else {}),
            "profile_s": round(profile_s, 3), "prefill_keys": keys}


def disagg_workload(vocab: int) -> list:
    rng = np.random.default_rng(7)
    prefix = rng.integers(1, vocab, DISAGG_PREFIX).tolist()
    return [(prefix + rng.integers(1, vocab, DISAGG_TAILS[i % 2]).tolist(), DISAGG_NEW[i % 2])
            for i in range(DISAGG_SESSIONS)]


def settle(cells: list) -> None:
    """Wait until the cells' engines hold no request (a stream's last line
    can reach the client before the engine releases its slot)."""
    for c in cells:
        for _ in range(1000):
            if not c.engine._requests and not any(c.engine._slot_req):
                break
            time.sleep(0.01)


def disagg_arm(arm: str, cells: list, workload: list) -> dict:
    """(b) One arm: its first 3 sessions to capture its keys (as the
    reference warms), then all of them measured, session 0 first (it opens
    the shared context) and the others together, streamed; the warm
    sessions' tokens again, no capture in the measured pass. ``mixed``:
    one cell; ``disagg``: a prefill and a decode cell."""
    servers = serve_cells(cells, DISAGG_PREFIX + DISAGG_TAILS[0])
    urls = [f"http://127.0.0.1:{s.server_address[1]}" for s in servers]

    def session(i, opened):
        body = {"promptTokens": workload[i][0], "maxNewTokens": workload[i][1],
                "prefixId": "agent"}
        if arm == "mixed":
            out = stream_generate(urls[0], body)
        else:
            out = http_handoff(urls[0], urls[1], body, True)
        opened.set()
        if len(out["tokens"]) != workload[i][1]:
            raise AssertionError(f"{arm} session {i}: {len(out['tokens'])} tokens")
        return out

    try:
        warm, _ = concurrently(session, 3, first_alone=True)
        settle(cells)
        forget_prefixes(cells)
        before = captures(cells)
        hits = [(c.engine.prefix_hits, c.engine.prefix_misses) for c in cells]
        res, wall = concurrently(session, len(workload), first_alone=True)
        after = captures(cells)
    finally:
        stop_cells(cells, servers)
    if after != before:
        raise AssertionError(f"{arm} arm: (decode, prefill) captures by cell {before} -> "
                             f"{after} in the measured pass")
    if [r["tokens"] for r in res[:3]] != [r["tokens"] for r in warm]:
        raise AssertionError(f"{arm} arm: the warm and measured passes gave different tokens")
    ttft = sorted(r["ttft_s"] * 1e3 for r in res)
    tokens = sum(len(r["tokens"]) for r in res)
    out = {"cells": [{"role": c.role, "slots": c.engine.num_slots,
                      "kv_page_tokens": c.engine.page_tokens,
                      "prefix_hits": c.engine.prefix_hits - h[0],
                      "prefix_misses": c.engine.prefix_misses - h[1]}
                     for c, h in zip(cells, hits)],
           "wall_s": round(wall, 3), "tokens": tokens, "tok_per_s": round(tokens / wall, 2),
           "ttft_ms_p50": round(statistics.median(ttft), 2),
           "ttft_ms_p95": round(ttft[min(len(ttft) - 1, math.ceil(0.95 * len(ttft)) - 1)], 2),
           "captures_in_measured_pass": 0,
           "session_tokens": [r["tokens"] for r in res]}
    if arm == "disagg":
        out.update(
            export_ms_p50=round(statistics.median(r["export_s"] for r in res) * 1e3, 2),
            wire_bytes_p50=statistics.median(r["wire_bytes"] for r in res),
            import_first_line_ms_p50=round(
                statistics.median(r["import_first_s"] for r in res) * 1e3, 2))
    return out


def forget_prefixes(cells: list) -> None:
    """Empty the cells' prefix caches (paged: free the pages they pin)."""
    for c in cells:
        eng = c.engine
        if eng.paged:
            eng._reclaim_prefix_pages(eng._pool.num_pages)
        else:
            eng._prefix_cache.clear()


def program_key_16():
    from kukeon_tpu_torch.serving.programs import program_key

    return program_key(16, False, False)


def serve_disagg(k1) -> dict:
    """The KV handoff (disaggregated serving) on llama3-8b int8, one draw:
    (a) parity against the ``serve`` phase (``disagg_parity``); (b) the
    reference's disagg arm scaled to 8B on one card: a paged cell with 8
    slots on a 64-page pool serves the sessions as the ``mixed`` arm, then
    as the ``decode`` cell of the ``disagg`` arm behind (a)'s legacy
    ``prefill`` cell, whose prefix cache takes the sessions' prefixId (the
    two arms' decode side is one engine; only its role and the route
    change)."""
    if "llama3-8b" not in SERVED_TOKENS:
        raise AssertionError("serve_disagg compares with the serve phase's tokens: run serve")
    t0 = time.monotonic()
    pre = make_cell("llama3-8b", 1024, role="prefill")
    parity = disagg_parity(k1, pre)
    parity_s = time.monotonic() - t0
    workload = disagg_workload(pre.cfg.vocab_size)
    side = twin_cell(pre, DISAGG_PAGE, role="mixed", num_slots=DISAGG_SLOTS,
                     kv_pool_pages=DISAGG_POOL)
    arms = {"mixed": disagg_arm("mixed", [side], workload)}
    settle([side])
    forget_prefixes([side])
    side.role = "decode"
    arms["disagg"] = disagg_arm("disagg", [pre, side], workload)
    # Both arms' decode side is this one engine: its 16-step replay alone.
    with torch.no_grad():
        step = replay_timing(side.engine._programs, program_key_16())
    for arm in arms.values():
        arm.update(decode_replay_event_ms_per_step=step["event_ms_per_step"],
                   decode_replay_kernel_device_ms_per_step=round(
                       step["kernel_device_ms"] / 16, 3))
    del pre, side
    same = sum(a == b for a, b in zip(arms["mixed"].pop("session_tokens"),
                                      arms["disagg"].pop("session_tokens")))
    return {"parity": parity, "parity_s": round(parity_s, 3), "arms": arms,
            "sessions_with_equal_tokens_across_arms": same,
            "workload": {"sessions": DISAGG_SESSIONS, "prefix": DISAGG_PREFIX,
                         "tails": DISAGG_TAILS, "new_tokens": DISAGG_NEW,
                         "decode_slots": DISAGG_SLOTS, "page_tokens": DISAGG_PAGE,
                         "pool_pages": DISAGG_POOL, "prefix_id": "agent",
                         "warm_sessions": 3, "source": "bench.py:505-521, scaled to 8B"}}


# serve_prefix: agent sessions, each turn the previous prompt plus the
# turn's generated tokens plus a user message.
PREFIX_SESSIONS, PREFIX_TURNS, PREFIX_FIRST, PREFIX_USER, PREFIX_NEW = 4, 6, 384, 32, 32
# A greedy divergence between a prefix hit and a full prefill is a near
# tie when the full prefill's logit gap between the two tokens is at most
# this share of its top logit's magnitude (bf16 rounds each product to
# 2^-8 relative; the two paths round the prefix's rows differently).
NEAR_TIE_SHARE = 0.02


def converse(base: str, prefix_id: str | None, first: list | None = None,
             users: list | None = None, prompts: list | None = None) -> tuple[list, list]:
    """Sessions over HTTP, turn t of every session submitted together ->
    (prompts [session][turn], answers [session][turn]). Each session grows
    from its ``first`` prompt by its answers and ``users`` messages, or
    sends the given ``prompts``. The device drains between turns, as an
    agent's own work between turns would let it: the engine's last decode
    chunk of a turn overshoots the requests' ends, and a turn sent at once
    would wait behind it."""
    n = len(prompts or first)
    sent = [[None] * PREFIX_TURNS for _ in range(n)]
    answers = [[None] * PREFIX_TURNS for _ in range(n)]
    cur = list(first or [])
    for t in range(PREFIX_TURNS):
        bodies = []
        for i in range(n):
            sent[i][t] = prompts[i][t] if prompts else cur[i]
            body = {"promptTokens": sent[i][t], "maxNewTokens": PREFIX_NEW}
            if prefix_id:
                body["prefixId"] = f"{prefix_id}-{i}"
            bodies.append(body)
        for i, r in enumerate(post_bodies(base, bodies)):
            if r is None or r["numTokens"] != PREFIX_NEW:
                raise AssertionError(f"session {i} turn {t + 1} came back wrong: {r}")
            answers[i][t] = r
            if not prompts:
                cur[i] = cur[i] + r["tokens"] + users[i][t]
        torch.cuda.synchronize()
    return sent, answers


def divergence(cell, prompt: list, want: list, got: list) -> dict | None:
    """The first position where ``got`` leaves ``want`` (the full
    prefill's greedy tokens), with the full prefill's logits there: the
    gap between its token and the hit's, and that gap's share of its top
    logit. None if they agree."""
    from kukeon_tpu_torch.models import llama

    j = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
    if j is None:
        return None
    dev = cell.engine.device
    toks = torch.tensor([prompt + want[:j]], device=dev)
    pos = torch.arange(toks.shape[1], device=dev)[None, :]
    with torch.no_grad():
        logits, _ = llama.forward(cell.engine.params, cell.engine.cfg, toks, pos,
                                  logit_positions=torch.tensor([toks.shape[1] - 1], device=dev))
    row = logits[0, 0].float()
    gap = float(row[want[j]] - row[got[j]])
    return {"position": j, "full_token": want[j], "hit_token": got[j],
            "logit_gap": round(gap, 5), "gap_share": round(gap / float(row.abs().max()), 5)}


def serve_prefix() -> dict:
    """llama3-8b int8, 4 slots, max_seq_len 1024, over HTTP: four agent
    sessions (prefixId sess-0..3) of six turns, 384 tokens the first, 32
    generated and a 32-token user message added each turn (704 the last),
    turn t of all four submitted together; then the same prompts without
    prefixId (the control). One session of each arm runs first, unmeasured,
    to capture the keys the traffic takes. Reports TTFT per turn and arm,
    the cache's hits and misses (4 and 20 over the measured sessions), the
    captures after warmup, and per session and turn whether the hit's
    greedy tokens equal the control's, with the first diverging position
    and the full prefill's logit gap there. Turn 1 is a full prefill in
    both arms and must be equal; turn 2, the first hit, must be equal or
    diverge at a near tie (NEAR_TIE_SHARE). Later turns read a prefix
    built by a chain of hits, whose roundings add up: reported only."""
    from kukeon_tpu_torch.runtime.serving_cell import serve

    torch.cuda.reset_peak_memory_stats()
    cell = make_cell("llama3-8b", 1024)
    t0 = time.monotonic()
    cell.warmup(PREFIX_FIRST)
    boot_s = time.monotonic() - t0
    eng = cell.engine
    eng.start()
    server = serve(cell)
    cell.mark_ready()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    g = torch.Generator().manual_seed(17)

    def rand(n):
        return torch.randint(0, cell.cfg.vocab_size, (n,), generator=g).tolist()

    def sessions(n):
        return ([rand(PREFIX_FIRST) for _ in range(n)],
                [[rand(PREFIX_USER) for _ in range(PREFIX_TURNS)] for _ in range(n)])

    stats, pstats = eng.program_stats, eng.program_stats["prefill"]
    try:
        warm = {"prefix": converse(base, "warm", *sessions(1)),
                "control": converse(base, None, *sessions(1))}
        captures = (stats["captures"], pstats["captures"])
        hits0, misses0 = eng.prefix_hits, eng.prefix_misses
        prompts, hit = converse(base, "sess", *sessions(PREFIX_SESSIONS))
        counts = {"hits": eng.prefix_hits - hits0, "misses": eng.prefix_misses - misses0}
        _, control = converse(base, None, prompts=prompts)
        now = (stats["captures"], pstats["captures"])
    finally:
        server.shutdown()
        server.server_close()
        eng.stop()
    if counts != {"hits": PREFIX_SESSIONS * (PREFIX_TURNS - 1), "misses": PREFIX_SESSIONS}:
        raise AssertionError(f"prefix cache {counts}, want 20 hits and 4 misses")
    if now != captures:
        raise AssertionError(f"(decode, prefill) captures {captures} -> {now} in the "
                             "measured traffic")
    agree, diverged = [], []
    for i in range(PREFIX_SESSIONS):
        for t in range(PREFIX_TURNS):
            a, b = control[i][t]["tokens"], hit[i][t]["tokens"]
            agree.append(a == b)
            if a != b:
                d = divergence(cell, prompts[i][t], a, b)
                diverged.append({"session": i, "turn": t + 1, **d})
                if t == 0 or (t == 1 and d["gap_share"] > NEAR_TIE_SHARE):
                    raise AssertionError(f"hit vs full prefill: {diverged[-1]}")

    def ttft(ans):
        return [[round(ans[i][t]["ttftSeconds"] * 1e3, 2) for i in range(PREFIX_SESSIONS)]
                for t in range(PREFIX_TURNS)]

    out = {"model": "llama3-8b", "sessions": PREFIX_SESSIONS, "turns": PREFIX_TURNS,
           "prompt_lens": [len(p) for p in prompts[0]], "boot_s": round(boot_s, 3),
           "prefix_cache": counts, "cache_stats": cell.stats()["prefixCache"],
           "ttft_ms_by_turn": {"prefix": ttft(hit), "control": ttft(control)},
           "ttft_ms_median_by_turn": {
               arm: [statistics.median(row) for row in ttft(ans)]
               for arm, ans in (("prefix", hit), ("control", control))},
           "ttft_ms_warm_session": {arm: [round(a["ttftSeconds"] * 1e3, 2) for a in w[1][0]]
                                    for arm, w in warm.items()},
           "captures_after_warmup": {"decode": stats["captures_after_warmup"],
                                     "prefill": pstats["captures_after_warmup"]},
           "prefill_programs": sorted(pstats["launches_by_key"]),
           "prefill_capture_s": round(pstats["capture_s"], 3),
           "prefill_pool_bytes": pstats["pool_bytes"],
           "turns_equal_to_control": f"{sum(agree)}/{len(agree)}",
           "first_hit_turn_equal": [hit[i][1]["tokens"] == control[i][1]["tokens"]
                                    for i in range(PREFIX_SESSIONS)],
           "diverged": diverged,
           "tolerance": f"turn 1 equal; turn 2 equal or diverging at a near tie (gap <= "
                        f"{NEAR_TIE_SHARE} x the top logit); later turns reported",
           "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 2)}
    del cell
    gc.collect()
    torch.cuda.empty_cache()
    return out


def flash_within_tol(out: torch.Tensor, ref: torch.Tensor,
                     v: torch.Tensor) -> tuple[bool, float, float]:
    """Kernel vs plain version. f32: 2e-5 relative plus absolute (the same
    math summed in another order). bf16: the two round p at different
    places (the kernel casts the unnormalised p to bf16 and divides by the
    f32 sum at the end; the plain version normalises, then casts), each a
    relative 2^-8 on every weight of the average, and both round the
    output: |err| <= 2^-7 (|ref| + max|v|), and the error's RMS within
    2^-7 of the output's, which a systematic error of 1% would break."""
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    rel_rms = float(err.pow(2).mean().sqrt() / r.pow(2).mean().sqrt())
    if ref.dtype == torch.float32:
        ok = bool(torch.all(err <= 2e-5 * (r.abs() + 1)))
    else:
        ok = bool(torch.all(err <= 2.0 ** -7 * (r.abs() + v.float().abs().max())))
        ok = ok and rel_rms <= 2.0 ** -7
    return ok and bool(torch.isfinite(o).all()), float(err.max()), rel_rms


def flash_flops(B: int, S: int, H: int, D: int) -> float:
    """Operations of causal attention's two products: 2 B H S^2 D."""
    return 2.0 * B * H * S * S * D


# The flash cases timed, and the key of each one's timing in the phase.
FLASH_TIMED = {"llama3-1b train": "timing", "mixtral train": "timing_mixtral_train"}


def phase_flash(fa, bps: float, flush: torch.Tensor) -> dict:
    """Hold the flash kernel against its plain version at every case; time
    it at the llama3-1b and the Mixtral training shapes."""
    import torch.nn.functional as F

    from kukeon_tpu_torch.ops.attention import repeat_kv

    g = torch.Generator(device="cuda").manual_seed(3)
    cases, timings = [], {}
    for label, B, S, H, KV, D, dt, offsets in FLASH_CASES:
        q = torch.randn((B, S, H, D), generator=g, device="cuda").to(dt)
        k = torch.randn((B, S, KV, D), generator=g, device="cuda").to(dt)
        v = torch.randn((B, S, KV, D), generator=g, device="cuda").to(dt)
        pos = torch.arange(S, device="cuda", dtype=torch.int32)[None, :].expand(B, S)
        if offsets is not None:
            pos = pos + torch.tensor(offsets, device="cuda", dtype=torch.int32)[:B, None]
        pos = pos.contiguous()
        out = fa.flash_attention(q, k, v, pos, pos)
        ref = fa.flash_attention_reference(q, k, v, pos, pos)
        torch.cuda.synchronize()
        ok, ea, rel = flash_within_tol(out, ref, v)
        cases.append({"case": label, "shape": [B, S, H, KV, D], "dtype": str(dt)[6:],
                      "max_abs_err": ea, "rel_rms_err": rel})
        if not ok:
            raise AssertionError(f"flash_attention disagrees with its plain version: "
                                 f"{cases[-1]}")
        if label not in FLASH_TIMED:
            continue
        n_rep = H // KV
        qt, kt, vt = (x.transpose(1, 2) for x in (q, repeat_kv(k, n_rep), repeat_kv(v, n_rep)))
        timing = {
            "ms": cold_median_ms(lambda: fa.flash_attention(q, k, v, pos, pos), flush),
            "plain_ms": cold_median_ms(
                lambda: fa.flash_attention_reference(q, k, v, pos, pos), flush),
            "library_ms": cold_median_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), flush),
            "library_call": "torch.nn.functional.scaled_dot_product_attention"
                            "(is_causal=True) on expanded K/V",
            "max_abs_err": ea, "shape": [B, S, H, KV, D],
        }
        e = q.element_size()
        t_bytes = (2 * B * S * H * D + 2 * B * S * KV * D) * e / bps * 1e3
        t_ops = flash_flops(B, S, H, D) / BF16_FLOPS * 1e3
        timing["bound_ms"], timing["bound_by"] = ((t_ops, "operations") if t_ops >= t_bytes
                                                  else (t_bytes, "bytes"))
        timing["tflops"] = flash_flops(B, S, H, D) / timing["ms"] / 1e9
        timing["peak_share"] = timing["tflops"] * 1e12 / BF16_FLOPS
        # The kernels' own device time (the cold median above also holds
        # whatever host time of the wrapper the L2 flush does not hide).
        timing["device_ms_per_call"] = kernel_device_ms(
            lambda: fa.flash_attention(q, k, v, pos, pos), flush)
        timing["device_ms"] = sum(timing["device_ms_per_call"].values())
        timing["device_peak_share"] = (flash_flops(B, S, H, D) / (timing["device_ms"] / 1e3)
                                       / BF16_FLOPS)
        timings[FLASH_TIMED[label]] = timing
        del qt, kt, vt
    return {"cases": cases, **timings,
            "tolerance": "bf16: |err| <= 2^-7 (|ref| + max|v|) and rms(err) <= 2^-7 "
                         "rms(ref); f32: |err| <= 2e-5 (|ref| + 1)"}


def flash_long(fa) -> list:
    """The flash kernel past the shape cases (FLASH_LONG), against the
    plain version on the query rows checked: all of them, or three slices
    (start, middle, end) against every key, the same function restricted
    to those rows, which keeps the plain version's f32 scores small."""
    g = torch.Generator(device="cuda").manual_seed(5)
    cases = []
    for label, B, S, H, KV, D, rows in FLASH_LONG:
        q = torch.randn((B, S, H, D), generator=g, device="cuda").to(torch.bfloat16)
        k = torch.randn((B, S, KV, D), generator=g, device="cuda").to(torch.bfloat16)
        v = torch.randn((B, S, KV, D), generator=g, device="cuda").to(torch.bfloat16)
        pos = torch.arange(S, device="cuda", dtype=torch.int32)[None, :].expand(B, S).contiguous()
        before = fa.flash_attention.launches
        out = fa.flash_attention(q, k, v, pos, pos)
        torch.cuda.synchronize()
        if fa.flash_attention.launches != before + 1:
            raise AssertionError(f"flash_attention at {label} launched no kernel")
        starts = [0] if rows is None else [0, (S - rows) // 2, S - rows]
        n = S if rows is None else rows
        worst_abs, worst_rel = 0.0, 0.0
        for a in starts:
            ref = fa.flash_attention_reference(q[:, a:a + n], k, v, pos[:, a:a + n], pos)
            ok, ea, rel = flash_within_tol(out[:, a:a + n], ref, v)
            if not ok:
                raise AssertionError(f"flash_attention disagrees with its plain version at "
                                     f"{label}, query rows {a}..{a + n}: max abs {ea}, "
                                     f"rel rms {rel}")
            worst_abs, worst_rel = max(worst_abs, ea), max(worst_rel, rel)
            del ref
        cases.append({"case": label, "shape": [B, S, H, KV, D], "query_rows_from": starts,
                      "query_rows": n, "max_abs_err": worst_abs, "rel_rms_err": worst_rel})
        del q, k, v, out
        torch.cuda.empty_cache()
    return cases


def embed_lengths(rng: np.random.Generator) -> list:
    """EMBED_SEQS lengths from 8 to 512, spread over every length bucket
    (an equal share in each bucket's range), in a random order."""
    from kukeon_tpu_torch.serving.embedding import EMBED_BUCKETS

    lo = [8] + [b + 1 for b in EMBED_BUCKETS[:-1]]
    per = -(-EMBED_SEQS // len(EMBED_BUCKETS))
    lengths = np.concatenate([rng.integers(a, b + 1, per) for a, b in zip(lo, EMBED_BUCKETS)])
    lengths[0], lengths[1] = 8, 512
    return [int(n) for n in rng.permutation(lengths[:EMBED_SEQS])]


def cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.sum(a * b, axis=-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def optional_packages() -> dict:
    """Which of the packages the port does not rely on import on this
    machine, each tried in a child process so that this one never loads
    them (a loaded ml_dtypes would give numpy a bfloat16): the
    safetensors, tokenizers and ml_dtypes the reference reads checkpoints
    with, and what an orbax reader (ROADMAP A10c) could stand on."""
    code = ("import importlib, json\nout = {}\n"
            "for m in ('safetensors', 'tokenizers', 'ml_dtypes', 'zstandard', 'tensorstore',"
            " 'orbax.checkpoint'):\n"
            "    try:\n        importlib.import_module(m)\n        out[m] = True\n"
            "    except Exception:\n        out[m] = False\n"
            "print(json.dumps(out))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, check=True)
    return json.loads(proc.stdout)


def tree_bitwise_equal(a: dict, b: dict, what: str) -> int:
    """Every leaf of ``a`` equals ``b``'s bit for bit (same keys, dtype,
    shape; either tree on any device) -> the number of leaves."""
    fa, fb = flat_leaves(a), flat_leaves(b)
    if fa.keys() != fb.keys():
        raise AssertionError(f"{what}: leaves differ: {sorted(fa.keys() ^ fb.keys())}")
    for k, x in fa.items():
        y = fb[k].to(x.device)
        if x.dtype != y.dtype or x.shape != y.shape or not x.is_contiguous() \
                or not y.is_contiguous() or not torch.equal(_bits(x), _bits(y)):
            raise AssertionError(f"{what}: leaf {k} differs ({x.dtype} {tuple(x.shape)} "
                                 f"against {y.dtype} {tuple(y.shape)})")
    return len(fa)


def flat_leaves(tree: dict, prefix: str = "") -> dict:
    """A nested tree -> {"a.b.c": leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def boot_report(cell, t0: float, ready_s: float) -> dict:
    """A checkpoint cell's boot: seconds from its construction (``t0``) to
    ready, the streamed load's stage seconds (disk and cast summed over the
    reader threads, upload on the engine's load thread; they overlap), the
    engine's boot marks in seconds after ``t0``, the
    ``kukeon_checkpoint_load_bytes_total`` its /metrics renders, and the
    bytes of its weight tree's leaves (which that counter must equal on a
    streamed boot)."""
    from kukeon_tpu_torch.obs import expo

    eng = cell.engine
    cs = eng._ckpt_stream.stat_snapshot() if eng._ckpt_stream is not None else {}
    m = parse_metrics(expo.render(cell.registry))
    return {"ready_s": round(ready_s, 3), "streamed": eng._ckpt_stream is not None,
            "stages_s": {"disk": round(cs.get("disk_s", 0.0), 3),
                         "cast": round(cs.get("cast_s", 0.0), 3),
                         "upload": round(eng.load_stats["upload_s"], 3)},
            "marks_s": {k: round(v - t0, 3) for k, v in sorted(eng.boot_marks.items(),
                                                                key=lambda kv: kv[1])},
            "load_bytes_counter": int(metric(m, "kukeon_checkpoint_load_bytes_total")),
            "leaf_bytes": sum(t.numel() * t.element_size()
                              for t in flat_leaves(eng.params).values())}


def check_streamed(report: dict, what: str) -> None:
    """A streamed boot's gate: the load-bytes counter equals the leaves'."""
    if not report["streamed"] or report["load_bytes_counter"] != report["leaf_bytes"]:
        raise AssertionError(f"{what}: streamed {report['streamed']}, "
                             f"kukeon_checkpoint_load_bytes_total "
                             f"{report['load_bytes_counter']}, leaf bytes {report['leaf_bytes']}")


def cell_tokens(make, prompts: list, new: int) -> tuple[list, dict]:
    """A cell from ``make()`` over HTTP: warmed, started and ready, then
    the prompts as concurrent requests -> (their greedy tokens, its
    :func:`boot_report`)."""
    from kukeon_tpu_torch.runtime.serving_cell import serve

    t0 = time.monotonic()
    cell = make()
    cell.warmup(len(prompts[0]))
    cell.engine.start()
    server = serve(cell)
    cell.mark_ready()
    ready_s = time.monotonic() - t0
    report = boot_report(cell, t0, ready_s)
    try:
        results = post_all(f"http://127.0.0.1:{server.server_address[1]}", prompts, new)
    finally:
        server.shutdown()
        server.server_close()
        cell.engine.stop()
    if any(r is None or r["numTokens"] != new for r in results):
        raise AssertionError(f"a checkpoint cell's request came back wrong: {results}")
    del cell
    gc.collect()
    torch.cuda.empty_cache()
    return [r["tokens"] for r in results], report


def engine_tokens(cfg, params, prompts: list, new: int, max_seq_len: int) -> list:
    """The same prompts through an engine over ``params``, stepped here:
    its greedy tokens."""
    from kukeon_tpu_torch.serving.engine import ServingEngine
    from kukeon_tpu_torch.serving.sampling import SamplingParams

    eng = ServingEngine(cfg, params, num_slots=len(prompts), max_seq_len=max_seq_len,
                        device="cuda")
    eng.precompile((len(prompts[0]),))
    eng.warmup(len(prompts[0]))
    reqs = [eng.submit(np.asarray(p, np.int32), SamplingParams(max_new_tokens=new))
            for p in prompts]
    with torch.no_grad():
        while not all(r.done.is_set() for r in reqs):
            eng.step()
    if any(r.error is not None or len(r.generated) != new for r in reqs):
        raise AssertionError(f"an in-memory engine's request failed: "
                             f"{[(r.error, len(r.generated)) for r in reqs]}")
    out = [list(r.generated) for r in reqs]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def tree_bytes(path: str) -> int:
    """Bytes of every file under ``path``, subdirectories included."""
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def serve_ckpt(k1) -> dict:
    """Serving from checkpoints: a llama3-1b HF checkpoint at full width
    and depth (tied head, f16, index layout over 1 GiB shards) written by
    the port's ``synthesize_hf_checkpoint`` into a temporary directory,
    then (a) ``load_params_quantized`` against ``quantize_params`` of the
    f32 ``load_params`` run on the card, bitwise; (b) ``save_quantized``
    and ``load_quantized`` give the same leaves, bitwise; (c) a cell booted
    with ``checkpoint=dir, dtype="int8"`` (``serve_model``: K1 112 and K1t
    1 a decode step in its profiled replays), a cell booted from the
    quantized directory, and an engine over (a)'s card-side tree give the
    same greedy tokens on ``serve_tied``'s prompts; (d) a bf16 cell booted
    from the directory gives the tokens of an engine over ``load_params``
    of it in memory. Each cell boots through the stream, then again on the
    tree its materialized loader gave (to ready: the loader's seconds plus
    the cell's). The directory is removed at the end."""
    from kukeon_tpu_torch.models import checkpoints, hf_convert, llama
    from kukeon_tpu_torch.runtime.serving_cell import ServingCell

    have = optional_packages()
    emit({"serve_ckpt_optional_packages": have})
    cfg = llama.llama3_1b()
    root = tempfile.mkdtemp(prefix="kukeon-ckpt-")
    hf, qdir = os.path.join(root, "hf"), os.path.join(root, "quant")
    seconds, out = {}, {"model": CKPT_MODEL, "optional_packages": have}

    def timed(name, fn):
        t0 = time.monotonic()
        r = fn()
        seconds[name] = round(time.monotonic() - t0, 3)
        return r

    try:
        timed("write_hf", lambda: checkpoints.synthesize_hf_checkpoint(
            hf, cfg, seed=0, max_shard_bytes=CKPT_SHARD_BYTES, tokenizer=have["tokenizers"]))
        files = sorted(os.listdir(hf))
        out["hf_files"] = files
        out["hf_bytes"] = dir_bytes(hf)
        if sum(f.endswith(".safetensors") for f in files) < 2:
            raise AssertionError(f"the checkpoint was meant to span several shards: {files}")
        # (a) the host's per-tensor quantization against the card's.
        host_q, qcfg = timed("load_hf_int8", lambda: hf_convert.load_params_quantized(hf))
        full, _ = timed("load_hf_f32", lambda: hf_convert.load_params(hf, dtype=torch.float32))
        card_full = timed("f32_to_card", lambda: synced(tree_to(full, "cuda")))
        del full
        gc.collect()
        out["scalar_divisor_scales"] = scalar_divisor_misses(card_full)
        # The norms (ones) take the activation dtype, as the loaders give them.
        card_q = timed("quantize_on_card", lambda: synced(
            norms_to(llama.quantize_params(card_full), qcfg.dtype)))
        del card_full
        gc.collect()
        torch.cuda.empty_cache()
        out["a_leaves_bitwise"] = tree_bitwise_equal(host_q, card_q, "(a) host vs card int8")
        # (b) the kukeon int8 checkpoint round trip.
        timed("save_quantized", lambda: checkpoints.save_quantized(qdir, host_q, qcfg))
        out["quant_bytes"] = dir_bytes(qdir)
        back, _ = timed("load_quantized", lambda: checkpoints.load_quantized(qdir))
        out["b_leaves_bitwise"] = tree_bitwise_equal(host_q, back, "(b) save/load quantized")
        # The rank readers of the HF directory under int8 at t 2 and 8: a
        # row-parallel leaf's scale from its whole rows, the tied head's
        # shard tile-padded; each block against (a)'s host tree.
        out["readers"] = rank_readers({"kind": "hf_int8", "root": hf}, host_q, qcfg, (2, 8))
        # (c) three routes to one int8 tree give one set of tokens.
        g = torch.Generator().manual_seed(7)
        prompts = [torch.randint(0, cfg.vocab_size, (CKPT_PROMPT,), generator=g).tolist()
                   for _ in range(4)]
        t0 = time.monotonic()
        cell = ServingCell(CKPT_MODEL, checkpoint=hf, dtype="int8", num_slots=4,
                           max_seq_len=CKPT_SEQ, device="cuda")
        construct_s = time.monotonic() - t0
        served = serve_model(k1, CKPT_MODEL, max_seq_len=CKPT_SEQ, prompt_len=CKPT_PROMPT,
                             new=CKPT_NEW, cell=cell, label="llama3-1b ckpt")
        boot = {"hf_int8": boot_report(cell, t0, construct_s + served["boot_s"])}
        del cell
        if SERVED_PROMPTS["llama3-1b ckpt"] != prompts:
            raise AssertionError("serve_model drew other prompts than serve_tied's")
        tokens_hf = SERVED_TOKENS["llama3-1b ckpt"]
        tokens_q, boot["quantized"] = cell_tokens(lambda: ServingCell(
            CKPT_MODEL, checkpoint=qdir, num_slots=4, max_seq_len=CKPT_SEQ, device="cuda"),
            prompts, CKPT_NEW)
        tokens_mem = engine_tokens(qcfg, card_q, prompts, CKPT_NEW, CKPT_SEQ)
        del card_q
        gc.collect()
        torch.cuda.empty_cache()
        if not tokens_hf == tokens_q == tokens_mem:
            raise AssertionError(f"(c) greedy tokens differ: HF int8 cell {tokens_hf}, "
                                 f"quantized cell {tokens_q}, engine {tokens_mem}")
        # (d) bf16 from the HF directory against the same weights in memory.
        tokens_bf16, boot["hf_bf16"] = cell_tokens(lambda: ServingCell(
            CKPT_MODEL, checkpoint=hf, num_slots=4, max_seq_len=CKPT_SEQ, device="cuda"),
            prompts, CKPT_NEW)
        bf16, bcfg = timed("load_hf_bf16", lambda: hf_convert.load_params(hf))
        tokens_bf16_mem = engine_tokens(bcfg, bf16, prompts, CKPT_NEW, CKPT_SEQ)
        if tokens_bf16 != tokens_bf16_mem:
            raise AssertionError(f"(d) bf16 greedy tokens differ: cell {tokens_bf16}, "
                                 f"engine {tokens_bf16_mem}")
        for fmt, report in boot.items():
            check_streamed(report, f"serve_ckpt {fmt} cell")
        # The same three cells booted the materialized way (the whole tree
        # in host memory first, then the engine): each cell boots on the
        # tree its materialized loader gave above, and its to-ready time is
        # that load's seconds plus the cell's own; the streamed boots'
        # comparison, with the same tokens.
        materialized = {}
        for fmt, tree, tcfg, kw, want in (
                ("hf_int8", host_q, qcfg, {"checkpoint": hf, "dtype": "int8"}, tokens_hf),
                ("quantized", back, qcfg, {"checkpoint": qdir}, tokens_q),
                ("hf_bf16", bf16, bcfg, {"checkpoint": hf}, tokens_bf16)):
            got, report = cell_tokens(lambda tree=tree, tcfg=tcfg, kw=kw: materialized_cell(
                tree, tcfg, CKPT_MODEL, num_slots=4, max_seq_len=CKPT_SEQ, device="cuda",
                **kw), prompts, CKPT_NEW)
            if got != want or report["streamed"]:
                raise AssertionError(f"serve_ckpt {fmt}: the materialized boot's tokens "
                                     f"{got} against the streamed boot's {want}")
            load_s = seconds[{"hf_int8": "load_hf_int8", "quantized": "load_quantized",
                              "hf_bf16": "load_hf_bf16"}[fmt]]
            materialized[fmt] = {"ready_s": round(load_s + report["ready_s"], 3),
                                 "load_s": load_s, "cell_s": report["ready_s"]}
        del host_q, back, bf16
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    out.update({
        "seconds": seconds,
        "ready_s": {fmt: report["ready_s"] for fmt, report in boot.items()},
        "ready_s_materialized": {fmt: m["ready_s"] for fmt, m in materialized.items()},
        "materialized": materialized,
        "boot": boot,
        "c_tokens_equal": True, "d_tokens_equal": True, "tokens_hf_int8": tokens_hf,
        "tokens_bf16_first": tokens_bf16[0],
        **{k: served[k] for k in ("ms_per_decode_step", "decode_tok_s", "ttft_ms",
                                  "launches", "peak_mem_gb")},
        "launches_per_step": served["profile"]["launches_per_step"],
        "dir_removed": not os.path.exists(root),
    })
    return out


def orbax_fixture_check() -> dict:
    """(a) of serve_orbax: the JAX-written fixture decoded here, by the
    decoder built here, every leaf against its recorded sha256. A gate, not
    a rate: the fixture's 1.3 MB of level-1 frames stay in cache."""
    import hashlib

    from kukeon_tpu_torch.models import orbax_ckpt

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), ORBAX_FIXTURE)
    with open(path + ".json") as f:
        want = {k: v["sha256"] for k, v in json.load(f).items()}
    ckpt = orbax_ckpt.OrbaxCheckpoint(path)
    leaves = flat_leaves(ckpt.read_tree())
    got = {k: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
           for k, a in leaves.items()}
    if got != want:
        bad = sorted(k for k in want.keys() | got.keys() if got.get(k) != want.get(k))
        raise AssertionError(f"serve_orbax (a): fixture leaves differ from their hashes: {bad}")
    return {"leaves": len(got), "sha256_equal": True,
            "frame_bytes": ckpt.stats["bytes_read"],
            "leaf_bytes": sum(a.nbytes for a in leaves.values())}


def orbax_boot(cell, report: dict, written: dict) -> dict:
    """An orbax cell's boot: the materialized load's stats beside its
    :func:`boot_report`, gated on the load-bytes counter equal to the
    bytes of the leaves written."""
    load = cell.checkpoint_load
    if not (report["load_bytes_counter"] == load["leaf_bytes"] == written["leaf_bytes"]):
        raise AssertionError(f"serve_orbax: kukeon_checkpoint_load_bytes_total "
                             f"{report['load_bytes_counter']}, leaf bytes loaded "
                             f"{load['leaf_bytes']}, written {written['leaf_bytes']}")
    return {"ready_s": report["ready_s"], "load_bytes_counter": report["load_bytes_counter"],
            **{k: round(v, 4) if isinstance(v, float) else v for k, v in load.items()}}


def serve_orbax(k1) -> dict:
    """Orbax checkpoints on the card (module docstring): (a) the
    JAX-written fixture against its hashes; (b) llama3-1b bf16 written by
    ``write_tree``, an int8 cell through ``serve_model`` (K1 112 and K1t 1 a
    step) and a bf16 cell, each against an engine over the same weights in
    memory; (c) bge-base's weights written and served again behind
    ``/v1/embed``, bit for bit. The directory is removed at the end."""
    from kukeon_tpu_torch.models import llama, orbax_ckpt
    from kukeon_tpu_torch.runtime.serving_cell import EmbeddingCell, ServingCell, serve

    out = {"a_fixture": orbax_fixture_check()}
    emit({"serve_orbax_fixture": out["a_fixture"]})
    cfg = llama.llama3_1b()
    root = tempfile.mkdtemp(prefix="kukeon-orbax-")
    lpath, bpath = os.path.join(root, "llama3-1b"), os.path.join(root, "bge-base")
    try:
        # (b) llama3-1b, full width and depth, bf16.
        gen = torch.Generator(device="cuda")
        gen.manual_seed(ORBAX_SEED)
        params = llama.init_params(cfg, gen, "cuda")
        written = orbax_ckpt.write_tree(lpath, params)
        out["llama_write"] = {"leaf_bytes": written["leaf_bytes"],
                              "bytes_on_disk": tree_bytes(lpath),
                              "write_s": round(written["seconds"], 3)}
        emit({"serve_orbax_write": out["llama_write"]})
        t0 = time.monotonic()
        cell = ServingCell(CKPT_MODEL, checkpoint=lpath, dtype="int8", num_slots=4,
                           max_seq_len=CKPT_SEQ, device="cuda")
        construct_s = time.monotonic() - t0
        served = serve_model(k1, CKPT_MODEL, max_seq_len=CKPT_SEQ, prompt_len=CKPT_PROMPT,
                             new=CKPT_NEW, cell=cell, label="llama3-1b orbax")
        boot = {"int8": orbax_boot(cell, boot_report(cell, t0, construct_s + served["boot_s"]),
                                   written)}
        del cell
        prompts = SERVED_PROMPTS["llama3-1b orbax"]
        tokens_int8 = SERVED_TOKENS["llama3-1b orbax"]
        tokens_mem = engine_tokens(cfg, llama.quantize_params(params), prompts, CKPT_NEW,
                                   CKPT_SEQ)
        if tokens_int8 != tokens_mem:
            raise AssertionError(f"serve_orbax (b): the int8 orbax cell's tokens {tokens_int8} "
                                 f"against the engine's over the same weights {tokens_mem}")
        held = []              # cell_tokens drops its cell: keep it for the load's stats
        tokens_bf16, report = cell_tokens(lambda: held.append(ServingCell(
            CKPT_MODEL, checkpoint=lpath, num_slots=4, max_seq_len=CKPT_SEQ,
            device="cuda")) or held[0], prompts, CKPT_NEW)
        boot["bf16"] = orbax_boot(held.pop(), report, written)
        tokens_bf16_mem = engine_tokens(cfg, params, prompts, CKPT_NEW, CKPT_SEQ)
        if tokens_bf16 != tokens_bf16_mem:
            raise AssertionError(f"serve_orbax (b): the bf16 orbax cell's tokens {tokens_bf16} "
                                 f"against the engine's over the same weights {tokens_bf16_mem}")
        del params
        gc.collect()
        torch.cuda.empty_cache()

        # (c) bge-base: a cell's weights written, then served again.
        mem = EmbeddingCell("bge-base", batch_size=EMBED_GRID, seed=ORBAX_SEED, device="cuda")
        bwritten = orbax_ckpt.write_tree(bpath, mem.engine.params)
        t0 = time.monotonic()
        ecell = EmbeddingCell("bge-base", batch_size=EMBED_GRID, checkpoint=bpath,
                              device="cuda")
        ecell.warmup()
        embed_ready_s = time.monotonic() - t0
        rng = np.random.default_rng(17)
        seqs = [rng.integers(1, mem.cfg.vocab_size, n).tolist()
                for n in embed_lengths(rng)[:EMBED_BURST]]
        mem.warmup()
        vecs = {}
        for name, c in (("orbax", ecell), ("memory", mem)):
            server = serve(c)
            c.mark_ready()
            try:
                got = post(f"http://127.0.0.1:{server.server_address[1]}/v1/embed",
                           {"inputTokens": seqs})
            finally:
                server.shutdown()
                server.server_close()
            vecs[name] = np.array(got["embeddings"], np.float32)
        if vecs["orbax"].shape != (len(seqs), mem.cfg.hidden_size) or \
                not np.array_equal(vecs["orbax"], vecs["memory"]):
            raise AssertionError("serve_orbax (c): the orbax bge-base cell's embeddings differ "
                                 "from those of the cell its weights came from")
        embed_load = {k: round(v, 4) if isinstance(v, float) else v
                      for k, v in ecell.checkpoint_load.items()}
        if embed_load["leaf_bytes"] != bwritten["leaf_bytes"]:
            raise AssertionError(f"serve_orbax (c): loaded {embed_load['leaf_bytes']} leaf "
                                 f"bytes, wrote {bwritten['leaf_bytes']}")
        del mem, ecell
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    out.update({
        "model": CKPT_MODEL, "boot": boot,
        "ready_s": {fmt: b["ready_s"] for fmt, b in boot.items()},
        "b_tokens_equal_memory": True, "tokens_int8": tokens_int8,
        "tokens_bf16_first": tokens_bf16[0],
        **{k: served[k] for k in ("ms_per_decode_step", "decode_tok_s", "ttft_ms",
                                  "launches", "peak_mem_gb")},
        "launches_per_step": served["profile"]["launches_per_step"],
        "c_embed": {"model": "bge-base", "sequences": len(seqs),
                    "lengths": [len(x) for x in seqs], "bitwise_equal": True,
                    "write_s": round(bwritten["seconds"], 3),
                    "bytes_on_disk": bwritten["bytes_written"],
                    "ready_s": round(embed_ready_s, 3), "load": embed_load},
        "dir_removed": not os.path.exists(root),
    })
    return out


def overlap_share(marks: dict) -> float | None:
    """The share of the load (first leaf to its last copy done) that ran
    while the programs were being captured, from an engine's boot marks."""
    if not {"capture_start", "capture_end", "load_start", "load_done"} <= marks.keys():
        return None
    load = marks["load_done"] - marks["load_start"]
    both = (min(marks["capture_end"], marks["load_done"])
            - max(marks["capture_start"], marks["load_start"]))
    return round(max(0.0, both) / load, 4) if load > 0 else None


def serve_stream(k1, pre) -> dict:
    """The streamed boot at 8B: ``serve``'s llama3-8b int8 tree (``pre``,
    serve's kept cell) saved as a kukeon int8 checkpoint into a temporary
    directory, then (a) a ServingCell booted with ``checkpoint=dir`` (the
    stream: reader threads, the engine's load thread, the captures
    meanwhile) and served ``serve``'s traffic through ``serve_model``: its
    greedy tokens must be ``serve``'s, 225 K1 a decode step in its
    profiled replays, and ``kukeon_checkpoint_load_bytes_total`` the tree's
    leaf bytes; (b) the same with ``chips=1``: a one-rank NCCL group whose
    rank streams its blocks (a ``"stream"`` recipe), with the same gates;
    (c) the rank readers at t 2, 4 and 8 on the same directory, the ranks
    of a t at once, each in a process of its own without a group
    (:func:`rank_readers`): each leaf's block sums as the block of serve's
    tree on the card. Reports the temp dir's free space, the save,
    construction to ready, the load's stages and the engine's boot marks
    (how much of the load the captures hid: a report, not a gate) of both
    cells. The directory is removed at the end."""
    from kukeon_tpu_torch.models import checkpoints
    from kukeon_tpu_torch.runtime.serving_cell import ServingCell

    root = tempfile.mkdtemp(prefix="kukeon-stream-")
    free_gb = round(shutil.disk_usage(root).free / 1e9, 1)
    emit({"serve_stream_tmp_free_gb": free_gb, "dir": root})
    try:
        t0 = time.monotonic()
        checkpoints.save_quantized(root, pre.engine.params, pre.cfg)
        save_s = time.monotonic() - t0
        nbytes = dir_bytes(root)
        t0 = time.monotonic()
        cell = ServingCell("llama3-8b", checkpoint=root, num_slots=4, max_seq_len=1024,
                           device="cuda")
        construct_s = time.monotonic() - t0
        served = serve_model(k1, "llama3-8b", max_seq_len=1024, prompt_len=128, new=64,
                             profile_new=8, cell=cell, label="llama3-8b stream")
        boot = boot_report(cell, t0, construct_s + served["boot_s"])
        del cell
        gc.collect()
        torch.cuda.empty_cache()
        check_streamed(boot, "serve_stream")
        if SERVED_TOKENS["llama3-8b stream"] != SERVED_TOKENS["llama3-8b"]:
            raise AssertionError("serve_stream: the streamed cell's greedy tokens differ "
                                 "from serve's")
        # (b) one rank of a group, streamed.
        tp1 = tp1_serve(k1, lambda: ServingCell("llama3-8b", checkpoint=root, num_slots=4,
                                                max_seq_len=1024, device="cuda", chips=1),
                        "llama3-8b stream tp1")
        tp1_boot = tp1["boot"]
        check_streamed(tp1_boot, "serve_stream (b)")
        # (c) the rank readers.
        readers = rank_readers({"kind": "kukeon_int8", "root": root}, pre.engine.params,
                               pre.cfg, (2, 4, 8))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"tmp_free_gb": free_gb, "save_s": round(save_s, 3), "checkpoint_bytes": nbytes,
            "construct_s": round(construct_s, 3), **boot,
            "capture_overlap_share_of_load": overlap_share(boot["marks_s"]),
            "tokens_equal_serve": True,
            **{k: served[k] for k in ("ms_per_decode_step", "decode_tok_s", "ttft_ms", "launches",
                                      "capture_s", "peak_mem_gb")},
            "launches_per_step": served["profile"]["launches_per_step"],
            "b_tp1": {**tp1_boot,
                      "capture_overlap_share_of_load": overlap_share(tp1_boot["marks_s"]),
                      **{k: tp1[k] for k in ("ms_per_decode_step", "decode_tok_s", "ttft_ms",
                                             "launches", "launches_per_step",
                                             "tokens_equal_serve", "mesh")}},
            "c_readers": readers,
            "dir_removed": not os.path.exists(root)}


class _RssPeak(threading.Thread):
    """This process's resident set (``VmRSS`` of /proc/self/status), read
    every 5 ms: its peak above the level when started. A rank reader runs
    it in a process of its own (:func:`fresh_readers`), where no heap freed
    by earlier work can be reused unseen. ``VmHWM``, the kernel's own
    high-water mark of the process, is read at the start and the end too,
    where /proc has it (None where it does not); ``ru_maxrss``
    (``getrusage``), the kernel's high-water mark again, at the end, where
    /proc has no ``VmHWM``."""

    def __init__(self):
        super().__init__(daemon=True)
        self.base = self.peak = _vm_kb("VmRSS")
        self.hwm_base = _vm_kb("VmHWM", required=False)
        self._done = threading.Event()

    def run(self):
        while not self._done.wait(0.005):
            self.peak = max(self.peak, _vm_kb("VmRSS"))

    def finish(self) -> dict:
        self._done.set()
        self.join()
        hwm = _vm_kb("VmHWM", required=False)
        mb = (lambda kb: None if kb is None else round(kb / 1024, 1))  # noqa: E731
        return {"rss_base_mb": round(self.base / 1024, 1),
                "rss_peak_growth_mb": round((self.peak - self.base) / 1024, 1),
                "vmhwm_base_mb": mb(self.hwm_base), "vmhwm_mb": mb(hwm),
                "ru_maxrss_mb": mb(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)}


def _vm_kb(key: str, required: bool = True) -> int | None:
    """``key``'s kB in /proc/self/status (None if absent and not
    ``required``)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1])
    if required:
        raise RuntimeError(f"/proc/self/status has no {key} line")
    return None


# The words block_sums takes at once: a multiple of its weights' period.
SUM_CHUNK = 65521 * 1024


def block_sums(t: torch.Tensor) -> list[int]:
    """Two exact integer sums of ``t``'s bytes, on its device: of its int16
    words (bytes, if their count is odd), and of each word times (its index
    mod 65521) + 1, so a block shifted, cut elsewhere or transposed does
    not pass. A term is below 2^31 and a leaf has fewer than 2^31 words:
    no sum leaves int64, so any two devices agree bit for bit."""
    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    w = b.view(torch.int16) if b.numel() % 2 == 0 else b
    k = torch.arange(min(SUM_CHUNK, w.numel()), dtype=torch.int64, device=w.device)
    k = k.remainder_(65521).add_(1)
    s1 = s2 = 0
    for o in range(0, w.numel(), SUM_CHUNK):
        x = w[o:o + SUM_CHUNK].to(torch.int64)
        s1 += int(x.sum())
        s2 += int((x * k[:x.numel()]).sum())
    return [s1, s2]


def _rank_stream(spec: dict):
    """A rank's leaves for ``spec`` (``kind``: ``kukeon_int8`` a kukeon int8
    directory, ``hf_int8`` an HF one quantized on the host, ``moe`` an HF
    Mixtral one through ``moe_rank_leaves``, quantized on the card) and a
    function giving its reader's stats."""
    from kukeon_tpu_torch.models import checkpoints, hf_convert

    where = dict(rank=spec["rank"], world=spec["world"], kv_shard=spec["kv_shard"])
    if spec["kind"] == "moe":
        peak = checkpoints.JobPeak()
        leaves = hf_convert.moe_rank_leaves(spec["root"], spec["cfg"], device=_card(),
                                            quantize=True, peak=peak, **where)
        return leaves, lambda: {"job_peak_bytes": peak.bytes}
    if spec["kind"] == "kukeon_int8":
        stream = checkpoints.stream_quantized(spec["root"], **where)
    else:
        stream = hf_convert.stream_params_quantized(spec["root"], threads=4, **where)
    return stream, lambda: {k: stream.stat_snapshot()[k] for k in ("read_bytes",
                                                                   "job_peak_bytes")}


def _reader_child(spec: dict, conn) -> None:
    """One rank's reader in a process of its own (:func:`fresh_readers`):
    its CUDA context first, then the resident set's baseline, then its
    leaves read to the end, each copied onto the card as an engine's load
    thread copies it and summed there (:func:`block_sums`). Sends the
    rank's report, or the traceback."""
    import traceback

    try:
        dev = _card()
        torch.empty(1, device=dev)
        rss = _RssPeak()
        rss.start()
        t0 = time.monotonic()
        leaves, stats = _rank_stream(spec)
        sums, slice_bytes = {}, 0
        for path, host in leaves:
            slice_bytes += host.numel() * host.element_size()
            leaf = host.to(dev)
            sums[".".join(path)] = [list(leaf.shape), str(leaf.dtype), *block_sums(leaf)]
            del host, leaf
        conn.send({"rank": spec["rank"], "seconds": round(time.monotonic() - t0, 3),
                   **stats(), "slice_bytes": slice_bytes, **rss.finish(), "sums": sums,
                   "wall_s": round(time.monotonic() - spec["started"], 3)})
    except BaseException:
        conn.send({"error": traceback.format_exc()})
    finally:
        conn.close()


def _card() -> str:
    """The card, or the host where there is none (a rehearsal). Asked at
    call time: the fork server must not initialise CUDA."""
    return "cuda" if torch.cuda.is_available() else "cpu"


_FORK = None


def fork_server():
    """The readers' multiprocessing context, its fork server started (once)
    with the preloads :func:`fresh_readers` describes. The server imports
    them in a process of its own, so a caller that starts it early hides
    that time behind its other work."""
    import multiprocessing
    from multiprocessing import forkserver

    global _FORK
    if _FORK is None:
        _FORK = multiprocessing.get_context("forkserver")
        _FORK.set_forkserver_preload(["__main__", "torch._dynamo",
                                      "kukeon_tpu_torch.models.hf_convert",
                                      "kukeon_tpu_torch.parallel.sharding"])
        atexit.register(_stop_fork)
        forkserver.ensure_running()
    return _FORK


def fresh_readers(specs: list, exiting: list, timeout: float = 300.0) -> list:
    """:func:`_reader_child` for every spec at once, each in a process
    forked from multiprocessing's fork server, which has imported this
    script, the port's readers and ``torch._dynamo`` (which the readers'
    meta-device draws import, 2 s and ~70 MB on a first use) and touched
    no card and no large buffer: each rank starts with a fresh heap and its
    own resident set, and the ranks read side by side, as a group's ranks
    read on one host. Their reports in the specs' order, each with
    ``wall_s`` from its start to its report (the fork, the CUDA context,
    the reads); a child that reported goes on ``exiting`` (its context torn
    down meanwhile, :func:`reap`). Raises with a child's traceback, or its
    exit code."""
    fork = fork_server()
    started = []
    for spec in specs:
        recv, send = fork.Pipe(duplex=False)
        proc = fork.Process(target=_reader_child,
                            args=({**spec, "started": time.monotonic()}, send), daemon=True)
        proc.start()
        send.close()
        started.append((spec, proc, recv))
    deadline = time.monotonic() + timeout
    out, failed = [], None
    for spec, proc, recv in started:
        who = f"rank reader {spec['rank']} of {spec['world']} ({spec['kind']})"
        try:
            if not recv.poll(max(0.0, deadline - time.monotonic())):
                failed = failed or f"{who}: no report in {timeout} s"
                continue
            got = recv.recv()
        except EOFError:
            proc.join(30)
            failed = failed or f"{who}: exited {proc.exitcode} with no report"
            continue
        finally:
            recv.close()
            exiting.append(proc)
        if "error" in got:
            failed = failed or f"{who}:\n{got['error']}"
        out.append(got)
    if failed:
        raise AssertionError(failed)
    return out


def reap(procs: list) -> None:
    """Waits for each reader process to exit; kills one still there after
    30 s."""
    for proc in procs:
        proc.join(30)
        if proc.is_alive():
            proc.kill()
            proc.join()


def _stop_fork() -> None:
    """Stops the fork server and the resource tracker it started, waiting
    for both (Python 3.12's stop methods, private ones)."""
    from multiprocessing import forkserver, resource_tracker

    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def rank_readers(spec: dict, ref_tree: dict, cfg, worlds) -> dict:
    """Each rank's reader of a tensor-parallel group of each world in
    ``worlds``, the ranks of a world at once, each in a process of its own
    without a group (:func:`fresh_readers`, ``spec`` less the rank's
    place): the shape,
    dtype and sums (:func:`block_sums`) of each leaf it yields must be
    those of ``Layout``'s block of ``ref_tree``'s leaf (the one-device
    tree), padding included, summed on the card leaf by leaf, so no
    process holds a rank's tree and the reader's own. Reports each rank's
    seconds (its reads, the copies to the card and the sums), the bytes it
    requested from disk, its leaves' bytes, the most a reader job declared
    at once (``job_peak_bytes``) and its process's resident-set growth
    over the baseline taken after its CUDA context; a world's ``wall_s``,
    its ranks started to the last one's report."""
    from kukeon_tpu_torch.models.checkpoints import _walk_tree
    from kukeon_tpu_torch.parallel.sharding import Layout, kv_sharded

    ref = dict(_walk_tree(ref_tree))
    out, exiting = {}, []
    try:
        for t in worlds:
            kv = kv_sharded(cfg.num_kv_heads, t)
            t0 = time.monotonic()
            ranks = fresh_readers([{**spec, "rank": r, "world": t, "kv_shard": kv}
                                   for r in range(t)], exiting)
            wall = time.monotonic() - t0
            for r, got in enumerate(ranks):
                check_rank_sums(got.pop("sums"), ref, Layout(cfg, r, t, kv),
                                f"rank {r} of {t}")
            out[f"t{t}"] = {"kv_sharded": kv, "ranks": ranks, "wall_s": round(wall, 3),
                            "seconds": round(sum(x["seconds"] for x in ranks), 3)}
    finally:
        reap(exiting)
    return out


def check_rank_sums(sums: dict, ref: dict, layout, who: str) -> None:
    """A rank's leaves (``sums``: path -> shape, dtype, sums) against
    ``layout``'s blocks of the one-device leaves ``ref``, each summed on
    the card: every leaf there, none more, each equal."""
    bad = sorted(set(sums) ^ {".".join(p) for p in ref})
    for path, full in ref.items():
        key = ".".join(path)
        if key not in sums:
            continue
        blk = layout.block(path, full.shape)
        want = (blk.place(blk.take(full)) if blk.axis is not None else full).to(_card())
        if sums[key] != [list(want.shape), str(want.dtype), *block_sums(want)]:
            bad.append(key)
        del want
    if bad:
        raise AssertionError(f"{who}: blocks differ from the one-device tree's at {bad[:5]}")


def load_autotune():
    """``tools/autotune.py`` as a module (tools/ is no package)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", "autotune.py")
    spec = importlib.util.spec_from_file_location("autotune", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def serve_tune(pre) -> dict:
    """The tuning profile and the layer profile at 8B, on ``serve``'s
    weights: a 2-arm sweep through ``tools/autotune.py``'s code (decode
    chunk 16 against 64, each arm a cell over ``pre``'s weights with
    ``serve``'s traffic, tokens equal to ``serve``'s), the winner saved with
    ``tuning.save`` into this run's profile file, then a cell built with
    every lever left None (drawn from ``serve``'s seed): it must take the
    winner's levers and answer ``serve``'s prompts with ``serve``'s greedy
    tokens. On that cell, ``POST /v1/profile {"layers": true}`` must
    persist a profile of 34 components and no error; the sum of the
    layers' decode times is reported beside the cell's measured decode
    step (HTTP) and a 16-step decode replay, timed alone. The profile file
    is removed at the end, so later phases boot untuned."""
    from kukeon_tpu_torch.runtime.serving_cell import ServingCell, serve
    from kukeon_tpu_torch.serving import tuning
    from kukeon_tpu_torch.serving.programs import program_key

    autotune = load_autotune()
    prompts, want = SERVED_PROMPTS["llama3-8b"], SERVED_TOKENS["llama3-8b"]
    arms = [(f"chunk{c}", {"decode_chunk": c, "kv_cache_int8": False, "kv_page_tokens": 0})
            for c in (16, 64)]
    results, best = autotune.sweep(
        lambda lv: twin_cell(pre, kv_page_tokens=lv["kv_page_tokens"],
                             decode_chunk=lv["decode_chunk"], kv_cache_int8=lv["kv_cache_int8"]),
        arms, prompts, 64)
    bad = {n: r.get("error") for n, r in results.items() if r.get("tokens") != want}
    if best is None or bad:
        raise AssertionError(f"serve_tune: arms failed or gave other tokens than serve's: {bad}")
    path = autotune.save_winner("llama3-8b", torch.device("cuda"), results[best])
    key = tuning.profile_key("llama3-8b", "gpu", 1)
    try:
        t0 = time.monotonic()
        cell = ServingCell("llama3-8b", dtype="int8", num_slots=4, max_seq_len=1024,
                           device="cuda")
        eng = cell.engine
        levers = results[best]["levers"]
        took = {"decode_chunk": eng.decode_chunk, "kv_cache_int8": eng.kv_cache_int8,
                "kv_page_tokens": eng.page_tokens}
        if eng.tune is None or took != {k: levers[k] for k in took}:
            raise AssertionError(f"serve_tune: the untuned cell took {took} "
                                 f"(profile {eng.tune}), the winner is {levers}")
        cell.warmup(len(prompts[0]))
        eng.start()
        server = serve(cell)
        cell.mark_ready()
        ready_s = time.monotonic() - t0
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            answers = post_all(base, prompts, 64)
            stats_tuning = get_json(base + "/v1/stats")["tuning"]
            t1 = time.monotonic()
            prof = post(base + "/v1/profile", {"layers": True, "prefillLen": 128,
                                               "decodeBatch": eng.num_slots})
            profile_s = time.monotonic() - t1
        finally:
            server.shutdown()
            server.server_close()
            eng.stop()
        if [a["tokens"] for a in answers] != want:
            raise AssertionError("serve_tune: the tuned cell's greedy tokens differ from serve's")
        stored = tuning.load_layer_profile("llama3-8b", "gpu", 1)
        names = [c["name"] for c in prof["components"]]
        if (prof["errors"] or len(names) != 34 or prof.get("key") != key or stored is None
                or stored["components"] != prof["components"] or not stats_tuning["fromProfile"]):
            raise AssertionError(f"serve_tune: layer profile errors {prof['errors']} "
                                 f"({[c for c in prof['components'] if 'error' in c][:3]}), "
                                 f"{len(names)} components, key {prof.get('key')}, "
                                 f"stored {stored is not None}, tuning {stats_tuning}")
        TUNE_PROFILE.update(shape=(prof["prefill_len"], prof["decode_batch"]),
                            counts=profile_counts(prof))
        with seated(cell, 128), torch.no_grad():
            replay = replay_timing(eng._programs, program_key(16, False, False))
    finally:
        os.remove(path)
    layers = [c for c in prof["components"] if c["name"].startswith("layer")]
    decode_ms = {c["name"]: c["decode"]["wall_s"] * 1e3 for c in prof["components"]}
    step_ms = [(a["seconds"] - a["ttftSeconds"]) / 63 * 1e3 for a in answers]
    del cell, eng
    gc.collect()
    torch.cuda.empty_cache()
    return {
        "arms": {n: {k: v for k, v in r.items() if k != "tokens"} for n, r in results.items()},
        "winner": best, "profile_key": key, "tuned_cell_levers": took,
        "tuned_cell_ready_s": round(ready_s, 3), "tokens_equal_serve": True,
        "stats_tuning": stats_tuning,
        "layer_profile": {
            "components": len(names), "errors": prof["errors"], "seconds": round(profile_s, 3),
            "prefill_len": prof["prefill_len"], "decode_batch": prof["decode_batch"],
            "decode_ms": {"embed": round(decode_ms["embed"], 4),
                          "layers_sum": round(sum(c["decode"]["wall_s"] for c in layers) * 1e3, 4),
                          "layer_median": round(statistics.median(
                              c["decode"]["wall_s"] for c in layers) * 1e3, 4),
                          "head": round(decode_ms["head"], 4),
                          "all_sum": round(sum(decode_ms.values()), 4)},
            "prefill_ms_sum": round(sum(c["prefill"]["wall_s"] for c in prof["components"])
                                    * 1e3, 4),
            "model_flops": prof["model_flops"],
            "flops_sum_prefill": sum(c["prefill"]["flops"] for c in prof["components"])},
        "ms_per_decode_step_http": round(statistics.median(step_ms), 3),
        "replay_16": replay,
    }


def materialized_cell(tree: dict, tcfg, *args, **kw):
    """A ServingCell booted on ``tree`` (with ``tcfg``), a checkpoint a
    materialized loader has already read whole into host memory: how the
    cell booted before the stream, less the load, which the caller timed."""
    from kukeon_tpu_torch.runtime.serving_cell import ServingCell

    class Materialized(ServingCell):
        @staticmethod
        def _load_checkpoint(path, cfg, quantize=False, **_kw):
            return tree, tcfg

    return Materialized(*args, **kw)


def scalar_divisor_misses(params: dict) -> dict:
    """The per-channel maxima of every matrix of an f32 Llama tree on the
    card, divided by 127 with a Python scalar divisor (CUDA multiplies by
    its reciprocal) and with a device tensor one (the IEEE quotient, which
    ``llama._int8_sym`` takes and numpy's ``quantize_np`` computes): how
    many of the scales differ, of how many."""
    mats = [params["embed"]] + [w for w in params["layers"].values() if w.dim() == 3]
    differ = total = 0
    for w in mats:
        a = w.abs().amax(dim=1)
        differ += int((a / 127.0 != a / a.new_full((), 127.0)).sum())
        total += a.numel()
    return {"differ": differ, "of": total}


def tree_to(tree: dict, device: str) -> dict:
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def norms_to(tree: dict, dtype: torch.dtype) -> dict:
    """The tree with its leaves other than int8 ``q`` and ``s`` cast."""
    return {k: norms_to(v, dtype) if isinstance(v, dict)
            else v if k in ("q", "s") else v.to(dtype) for k, v in tree.items()}


def synced(x):
    torch.cuda.synchronize()
    return x


# serve_embed's timed bursts and their vectors, which serve_tp_cells' one-rank
# embedding cell must give bit for bit.
EMBEDDED: dict = {}


def serve_embed() -> dict:
    """bge-base behind the port's EmbeddingCell over HTTP (module docstring)."""
    from kukeon_tpu_torch.models import bert
    from kukeon_tpu_torch.runtime.serving_cell import EmbeddingCell, serve
    from kukeon_tpu_torch.serving import EmbeddingEngine

    t0 = time.monotonic()
    cell = EmbeddingCell("bge-base", batch_size=EMBED_GRID, device="cuda")
    cell.warmup()
    boot_s = time.monotonic() - t0
    server = serve(cell)
    cell.mark_ready()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    cfg = cell.cfg
    try:
        rng = np.random.default_rng(13)
        lengths = embed_lengths(rng)
        seqs = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lengths]
        bursts = [seqs[i:i + EMBED_BURST] for i in range(0, len(seqs), EMBED_BURST)]
        passes = {}
        for name in ("warm", "timed"):
            vecs, burst_ms = [], []
            t0 = time.monotonic()
            for burst in bursts:
                t1 = time.monotonic()
                out = post(base + "/v1/embed", {"inputTokens": burst})
                burst_ms.append((time.monotonic() - t1) * 1e3)
                if out["numSequences"] != len(burst) or out["dim"] != cfg.hidden_size:
                    raise AssertionError(f"/v1/embed answered {out['numSequences']} vectors "
                                         f"of {out['dim']}")
                vecs.extend(out["embeddings"])
            passes[name] = {"wall_s": time.monotonic() - t0, "burst_ms": burst_ms,
                            "vecs": np.array(vecs, np.float32)}
        vecs = passes["timed"]["vecs"]
        texts = ["an agent's tool call", "the same agent, another call",
                 "a much longer string of text for the byte tokenizer to embed, " * 4]
        text_out = post(base + "/v1/embed", {"inputs": texts})
        text_vecs = np.array(text_out["embeddings"], np.float32)
        # The shortest sequence of a burst that reached the 512 bucket,
        # alone: its grid is its own bucket, 15 rows padded.
        burst = next(b for b in bursts if max(len(x) for x in b) > 256)
        k = min(range(len(burst)), key=lambda i: len(burst[i]))
        alone = np.array(post(base + "/v1/embed", {"inputTokens": [burst[k]]})["embeddings"][0],
                         np.float32)
        in_grid = vecs[bursts.index(burst) * EMBED_BURST + k]
        m, _ms = scrape(base)
        sent = 2 * len(seqs) + len(texts) + 1
        counted = metric(m, "kukeon_embed_sequences_total")
    finally:
        server.shutdown()
        server.server_close()

    # The port's own f32 forward of the same weights, on the card.
    f32 = EmbeddingEngine(dataclasses.replace(cfg, dtype=torch.float32),
                          {g: {n: t.float() for n, t in tree.items()}
                           for g, tree in cell.engine.params.items()},
                          batch_size=EMBED_GRID, device="cuda")
    want = f32.embed_batch([np.asarray(x, np.int32) for x in seqs])
    del f32, cell
    norms = np.linalg.norm(np.concatenate([vecs, text_vecs, alone[None]]), axis=-1)
    cos_f32 = cosines(vecs, want)
    cos_alone = float(cosines(alone[None], in_grid[None])[0])
    repeat_equal = bool(np.array_equal(passes["warm"]["vecs"], vecs))
    if not np.all(np.abs(norms - 1) <= 1e-3):
        raise AssertionError(f"bge-base: vectors off unit norm: {norms.min()}..{norms.max()}")
    if cos_f32.min() < 0.999:
        raise AssertionError(f"bge-base bf16 against f32: cosine {cos_f32.min()} < 0.999")
    if cos_alone < 0.9999:
        raise AssertionError(f"bge-base: one sequence alone against in a padded grid: "
                             f"cosine {cos_alone} < 0.9999")
    if counted != sent:
        raise AssertionError(f"/metrics counts {counted} sequences, {sent} were sent")
    EMBEDDED.update(bursts=bursts, vecs=vecs)
    timed = passes["timed"]
    return {"model": "bge-base", "dtype": "bfloat16", "params": cfg.param_count(),
            "grid_rows": EMBED_GRID, "sequences": len(seqs), "burst": EMBED_BURST,
            "lengths": lengths, "tokens": int(sum(lengths)), "boot_s": round(boot_s, 3),
            "seq_per_s": round(len(seqs) / timed["wall_s"], 1),
            "tokens_per_s": round(sum(lengths) / timed["wall_s"], 1),
            "burst_ms": [round(x, 3) for x in timed["burst_ms"]],
            "burst_ms_p50": round(statistics.median(timed["burst_ms"]), 3),
            "warm_pass_burst_ms": [round(x, 3) for x in passes["warm"]["burst_ms"]],
            "repeat_bitwise_equal": repeat_equal,
            "norm_err_max": float(np.abs(norms - 1).max()),
            "cosine_to_f32_min": float(cos_f32.min()),
            "alone_vs_in_grid": {"length": len(burst[k]), "grid_len": 512,
                                 "cosine": cos_alone},
            "metrics_sequences_total": counted}


def zipf_dataset(path: str, n_tokens: int, seed: int, vocab: int = 4096) -> None:
    """Token ids with a Zipf-like law over the first min(4096, vocab) ids
    of the vocabulary: a unigram the model can learn within a few steps."""
    from kukeon_tpu_torch.training import TokenDataset

    rng = np.random.default_rng(seed)
    TokenDataset.write(path, (rng.zipf(1.2, n_tokens) - 1) % min(4096, vocab))


def profile_train_step(data: str) -> dict:
    """torch.profiler over one llama3-1b train step (after two warm-up
    steps), outside the CLI: device busy share of the step's wall time,
    the flash kernel's device time, and the kernels that take the most."""
    from torch.profiler import ProfilerActivity, profile

    from kukeon_tpu_torch.models import llama
    from kukeon_tpu_torch.training import TokenDataset, batches, create_train_state
    from kukeon_tpu_torch.training.train_step import make_optimizer, make_train_step

    cfg = llama.llama3_1b()
    opt = make_optimizer(3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    state, opt = create_train_state(cfg, torch.Generator(device="cuda").manual_seed(1),
                                    "cuda", opt)
    step = make_train_step(cfg, opt)
    feed = batches(TokenDataset(data), TRAIN_B, TRAIN_S, num_steps=3, device="cuda")
    for i, (_s, *batch) in enumerate(feed):
        if i < 2:
            state, loss = step(state, *batch)
            float(loss)
            continue
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            state, loss = step(state, *batch)
            float(loss)
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
    return step_breakdown(prof, wall_ms)


def step_breakdown(prof, wall_ms: float) -> dict:
    """A profiled train step: device busy and idle share of its wall time,
    device ms by kernel kind, and the kernels that take the most."""
    kernels = device_kernels(prof)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3

    def kind(name: str) -> str:
        low = name.lower()
        if "flash_fwd" in name:
            return "flash"
        if any(w in low for w in ("gemm", "xmma", "nvjet", "cutlass")):
            return "gemm_f32" if "f32f32_f32f32" in low or "sgemm" in low else "gemm_bf16"
        return "softmax" if "softmax" in low else "other"

    by_kind: dict[str, float] = {}
    for e in kernels:
        by_kind[kind(e.key)] = by_kind.get(kind(e.key), 0.0) + dev_us(e) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    return {"wall_ms": round(wall_ms, 2), "device_busy_ms": round(busy_ms, 2),
            "device_idle_share": round(1 - busy_ms / wall_ms, 4),
            "device_ms_by_kind": {k: round(v, 3) for k, v in sorted(by_kind.items())},
            "top_device_ms": [[e.key[:70], round(dev_us(e) / 1e3, 3), e.count] for e in top]}


def cli_train_twice(fa, common: list, steps: int, more: int) -> dict:
    """The training CLI (``common`` holds ``--ckpt-dir``) for ``steps``
    steps, then again to ``steps + more``, resuming: each run's log and
    flash launches (the counter set to 0 just before it), the first run's
    peak memory and checkpoints (all but the newest deleted after it), and
    host copies of the params saved at ``steps`` and of those the second run
    restored."""
    import kukeon_tpu_torch.training as training
    from kukeon_tpu_torch.training import cli
    from kukeon_tpu_torch.training.train_step import tree_leaves

    ckpt = common[common.index("--ckpt-dir") + 1]
    saved, restored, saves, exact = {}, {}, [], []
    real_save, real_restore = training.save_checkpoint, training.restore_checkpoint
    real_make_step = training.make_train_step

    def make_step(*a, **kw):        # each step's loss as the float it is
        step = real_make_step(*a, **kw)

        def run(*sa):
            state, loss = step(*sa)
            exact.append(float(loss))
            return state, loss
        return run

    def save(root, state):          # keeps a host copy of what was saved at the end
        if state.step == steps and "params" not in saved:
            saved["params"] = [t.detach().to("cpu", copy=True) for t in tree_leaves(state.params)]
        t0 = time.monotonic()
        path = real_save(root, state)
        # A repeated save of a step already on disk returns at once: not
        # counted.
        if not any(x["step"] == state.step for x in saves):
            saves.append({"step": int(state.step), "s": round(time.monotonic() - t0, 3),
                          "bytes": tree_bytes(path)})
        return path

    def restore(root, template, step=None):
        state = real_restore(root, template, step)
        restored["step"] = state.step
        restored["params"] = [t.detach().to("cpu", copy=True) for t in tree_leaves(state.params)]
        return state

    out = {}
    training.save_checkpoint, training.restore_checkpoint = save, restore
    training.make_train_step = make_step
    try:
        for run, total in (("first", steps), ("second", steps + more)):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            buf = io.StringIO()
            fa.flash_attention.launches = 0
            with contextlib.redirect_stdout(buf):
                rc = cli.main(common + ["--steps", str(total)])
            torch.cuda.synchronize()
            out[run] = {"rc": rc, "log": buf.getvalue(),
                        "launches": fa.flash_attention.launches,
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            if run == "first":
                out["steps_saved"] = sorted(os.listdir(ckpt))
                for d in out["steps_saved"][:-1]:          # disk: keep the newest
                    shutil.rmtree(os.path.join(ckpt, d))
    finally:
        training.save_checkpoint, training.restore_checkpoint = real_save, real_restore
        training.make_train_step = real_make_step
    out["saved"], out["restored"], out["saves"], out["exact_losses"] = (saved, restored, saves,
                                                                        exact)
    sys.stdout.write(out["first"]["log"] + out["second"]["log"])
    return out


def check_cli_runs(r: dict, steps: int, more: int, saves: list) -> tuple[dict, dict, list]:
    """Gate :func:`cli_train_twice`'s runs: exit 0, the step lines of both
    runs, finite and falling losses, the checkpoints ``saves``, the resume
    at ``steps`` and the restored params equal to the saved ones. Returns
    each run's {step: (loss, tok/s)} and the losses in order."""

    def parse(log):
        rows = [ln.split() for ln in log.splitlines() if ln.startswith("step ")]
        # "step N loss X [lb=Y] (T tok/s)": the tok/s is the next to last field.
        return {int(row[1]): (float(row[3]), float(row[-2].lstrip("("))) for row in rows}

    run1, run2 = parse(r["first"]["log"]), parse(r["second"]["log"])
    losses = [run1[i][0] for i in sorted(run1)] + [run2[i][0] for i in sorted(run2)]
    if r["first"]["rc"] != 0 or r["second"]["rc"] != 0:
        raise AssertionError(f"training exited {r['first']['rc']}, {r['second']['rc']}")
    if sorted(run1) != list(range(1, steps + 1)) or \
            sorted(run2) != list(range(steps + 1, steps + more + 1)):
        raise AssertionError(f"unexpected step lines: {sorted(run1)}, {sorted(run2)}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    if r["steps_saved"] != [f"step_{s:08d}" for s in saves]:
        raise AssertionError(f"checkpoints {r['steps_saved']}, want steps {saves}")
    if f"train: resumed from step {steps}" not in r["second"]["log"] or \
            r["restored"].get("step") != steps:
        raise AssertionError(f"the second run did not resume at step {steps}")
    saved, restored = r["saved"]["params"], r["restored"]["params"]
    if len(saved) != len(restored) or not all(
            torch.equal(a, b) for a, b in zip(saved, restored)):
        raise AssertionError("restored params differ from the saved ones")
    return run1, run2, losses


def phase_train(fa) -> dict:
    """The port's trainer, in process, through its entry point."""
    from kukeon_tpu_torch.models import llama

    cfg = llama.llama3_1b()
    tmp = tempfile.mkdtemp(prefix="kukeon-train-")
    try:
        data = os.path.join(tmp, "tokens.bin")
        zipf_dataset(data, 4_000_000, seed=0)
        common = ["--dataset", data, "--model", "llama3-1b", "--batch", str(TRAIN_B),
                  "--seq-len", str(TRAIN_S), "--lr", "3e-4", "--warmup-steps", "1",
                  "--log-every", "1", "--ckpt-dir", os.path.join(tmp, "ckpt"),
                  "--save-every", str(TRAIN_STEPS)]
        r = cli_train_twice(fa, common, TRAIN_STEPS, TRAIN_MORE)
        gc.collect()
        torch.cuda.empty_cache()
        prof = profile_train_step(data)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    run1, _run2, losses = check_cli_runs(r, TRAIN_STEPS, TRAIN_MORE, [TRAIN_STEPS])
    launches, launches2 = r["first"]["launches"], r["second"]["launches"]
    per_step = 2 * cfg.num_layers       # forward + remat recompute, every layer
    if launches != per_step * TRAIN_STEPS or launches2 != per_step * TRAIN_MORE:
        raise AssertionError(f"flash launches {launches} and {launches2}, want "
                             f"{per_step} a step")
    tokens = TRAIN_B * TRAIN_S
    step_ms = statistics.median(tokens / run1[i][1] * 1e3 for i in range(3, TRAIN_STEPS + 1))
    flops = (6.0 * cfg.param_count() * tokens
             + 3 * cfg.num_layers * flash_flops(TRAIN_B, TRAIN_S, cfg.num_heads, cfg.head_dim))
    return {"model": "llama3-1b", "batch": TRAIN_B, "seq_len": TRAIN_S,
            "steps": TRAIN_STEPS, "resumed_steps": TRAIN_MORE,
            "params": cfg.param_count(), "losses": losses, "exact_losses": r["exact_losses"],
            "first_loss": losses[0], "last_loss": losses[-1],
            "step_ms_median_3_8": round(step_ms, 3),
            "tokens_per_s": round(tokens / step_ms * 1e3, 1),
            "mfu": round(flops / (step_ms / 1e3) / BF16_FLOPS, 4),
            "mfu_flops_per_step": flops,
            "peak_mem_gb": round(r["first"]["peak_gb"], 2),
            "flash_launches": launches, "flash_launches_per_step": launches // TRAIN_STEPS,
            "flash_launches_resumed": launches2,
            "resumed_from": r["restored"]["step"], "restored_params_bitwise_equal": True,
            "checkpoint_format": "orbax", "saves": r["saves"],
            "save_s": [x["s"] for x in r["saves"]],
            "step_dir_bytes": r["saves"][-1]["bytes"] if r["saves"] else None,
            "profile": prof}


# train_tp: steps of (b), and the tensor sizes of (a)'s shard shapes.
TRAIN_TP_STEPS = 3
TRAIN_TP_WORLDS = (2, 4, 8)


def flash_at_shape(fa, g: torch.Generator, flush: torch.Tensor, bps: float, B: int, S: int,
                   H: int, KV: int, D: int, what: str) -> dict:
    """The flash kernel on random bf16 q, k, v of [B, S, H or KV, D] at
    positions 0..S-1, against its plain version (one launch, counted, and
    :func:`flash_within_tol`; ``what`` names the shape in a failure);
    cold-L2 kernel, plain and SDPA ms, the kernel's device ms, and its
    bound."""
    import torch.nn.functional as F

    from kukeon_tpu_torch.ops.attention import repeat_kv

    pos = torch.arange(S, device="cuda", dtype=torch.int32)[None, :].expand(B, S).contiguous()
    q, k, v = (torch.randn((B, S, n, D), generator=g, device="cuda").to(torch.bfloat16)
               for n in (H, KV, KV))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, pos, pos)
    launched = fa.flash_attention.launches - before
    ref = fa.flash_attention_reference(q, k, v, pos, pos)
    torch.cuda.synchronize()
    ok, ea, rel = flash_within_tol(got, ref, v)
    if not ok or launched != 1:
        raise AssertionError(f"flash_attention at {what} (B {B}, S {S}, H {H}, KV {KV}, "
                             f"D {D}): max abs {ea}, rel rms {rel}, {launched} launches")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, repeat_kv(k, H // KV), repeat_kv(v, H // KV)))
    call = (lambda: fa.flash_attention(q, k, v, pos, pos))
    t_bytes = (2 * B * S * H * D + 2 * B * S * KV * D) * 2 / bps * 1e3
    t_ops = flash_flops(B, S, H, D) / BF16_FLOPS * 1e3
    return {
        "shape": [B, S, H, KV, D], "max_abs_err": ea, "rel_rms_err": rel,
        "ms": round(cold_median_ms(call, flush), 4),
        "plain_ms": round(cold_median_ms(
            lambda: fa.flash_attention_reference(q, k, v, pos, pos), flush), 4),
        "library_ms": round(cold_median_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), flush), 4),
        "device_ms": round(sum(kernel_device_ms(call, flush).values()), 4),
        "bound_ms": round(max(t_ops, t_bytes), 4),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


FLASH_TOLERANCE = "bf16: |err| <= 2^-7 (|ref| + max|v|) and rms(err) <= 2^-7 rms(ref)"


def train_tp_kernels(fa, bps: float, B: int = TRAIN_B, layers: int = 32) -> dict:
    """(a): the flash kernel at a train rank's heads of a model with H 32,
    KV 8, D 128 and ``layers`` layers (llama3-8b at train's B; Mixtral-8x7B
    at train_moe's), S 2048, H 32/t and KV 8/t at each t of
    TRAIN_TP_WORLDS, against its plain version (:func:`flash_at_shape`)."""
    g = torch.Generator(device="cuda").manual_seed(23)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for t in TRAIN_TP_WORLDS:
        out[f"t{t}"] = {**flash_at_shape(fa, g, flush, bps, B, TRAIN_S, 32 // t, 8 // t, 128,
                                         f"the t={t} train shard"),
                        "launches_per_rank_step": 2 * layers}
    del flush
    return {"worlds": out, "max_abs_err": max(r["max_abs_err"] for r in out.values()),
            "library_call": "torch.nn.functional.scaled_dot_product_attention"
                            "(is_causal=True) on expanded K/V",
            "tolerance": FLASH_TOLERANCE}


def one_device_losses(data: str, steps: int) -> list:
    """train's first ``steps`` losses, from its init, optimizer and batches
    on one device, outside the CLI (when train did not run)."""
    from kukeon_tpu_torch.models import llama
    from kukeon_tpu_torch.training import TokenDataset, batches, create_train_state
    from kukeon_tpu_torch.training.train_step import make_optimizer, make_train_step

    cfg = llama.llama3_1b()
    opt = make_optimizer(3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    state, opt = create_train_state(cfg, torch.Generator(device="cuda").manual_seed(0),
                                    "cuda", opt)
    step = make_train_step(cfg, opt)
    losses = []
    for _s, *batch in batches(TokenDataset(data), TRAIN_B, TRAIN_S, num_steps=steps,
                              device="cuda"):
        state, loss = step(state, *batch)
        losses.append(float(loss))
    del state, step
    return losses


def train_tp_mesh(fa, want: list | None) -> dict:
    """(b): llama3-1b through MeshTrainer on a one-rank NCCL group,
    TRAIN_TP_STEPS steps of train's configuration (seed 0, lr 3e-4, warmup
    1, total TRAIN_STEPS, its zipf dataset): the losses against ``want``
    (train's exact losses; None: one_device_losses) bit for bit, flash
    launches a step (the counter set to 0 just before the steps), ms a step
    and peak memory; the group shut down after."""
    import torch.distributed as dist

    from kukeon_tpu_torch.models import llama
    from kukeon_tpu_torch.parallel import launch
    from kukeon_tpu_torch.parallel.mesh import make_mesh
    from kukeon_tpu_torch.parallel.sharding import TrainLayout
    from kukeon_tpu_torch.training.mesh_trainer import MeshTrainer

    cfg = llama.llama3_1b()
    tmp = tempfile.mkdtemp(prefix="kukeon-train-tp-")
    try:
        data = os.path.join(tmp, "tokens.bin")
        zipf_dataset(data, 4_000_000, seed=0)
        if want is None:
            want = one_device_losses(data, TRAIN_TP_STEPS)
            gc.collect()
            torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mesh = make_mesh(device="cuda")
        backend = dist.get_backend()
        if mesh.size != 1 or launch.current() is None or backend != "nccl":
            raise AssertionError(f"make_mesh() on one card: {mesh}, backend {backend}")
        t0 = time.monotonic()
        tr = MeshTrainer(mesh, model="llama3-1b", dataset=data, batch=TRAIN_B,
                         seq_len=TRAIN_S, seed=0, lr=3e-4, warmup_steps=1,
                         total_steps=TRAIN_STEPS)
        init_s = time.monotonic() - t0
        fa.flash_attention.launches = 0
        losses, step_ms = [], []
        for i in range(TRAIN_TP_STEPS):
            t0 = time.monotonic()
            losses.append(float(tr.step(i)))             # waits for the device
            step_ms.append((time.monotonic() - t0) * 1e3)
        launches = fa.flash_attention.launches
        peak = torch.cuda.max_memory_allocated()
        tr.close()
        del tr
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        launch.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    per_step = 2 * cfg.num_layers
    if losses != want[:TRAIN_TP_STEPS]:
        raise AssertionError(f"mesh trainer losses {losses} differ from train's "
                             f"{want[:TRAIN_TP_STEPS]}")
    if launches != per_step * TRAIN_TP_STEPS:
        raise AssertionError(f"mesh trainer: {launches} flash launches, want {per_step} a step")
    cfg8 = llama.llama3_8b()
    state_gb = {name: round(TrainLayout(cfg8, 0, f, 0, t).state_bytes() / 1e9, 3)
                for name, f, t in (("one_device", 1, 1), ("fsdp8", 8, 1),
                                   ("fsdp4_tensor2", 4, 2))}
    return {"model": "llama3-1b", "batch": TRAIN_B, "seq_len": TRAIN_S, "backend": backend,
            "losses": losses, "losses_equal_train": True, "init_s": round(init_s, 3),
            "step_ms": [round(x, 3) for x in step_ms],
            "step_ms_median_2_3": round(statistics.median(step_ms[1:]), 3),
            "peak_mem_gb": round(peak / 1e9, 2),
            "flash_launches": launches, "flash_launches_per_step": launches // TRAIN_TP_STEPS,
            "llama3-8b_rank_state_gb": state_gb}


def train_tp_overgrant() -> dict:
    """(c): the CLI with --fsdp 2 on one card exits with the over-grant
    message, and no byte reaches the card."""
    from kukeon_tpu_torch.training import cli

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    try:
        cli.main(["--dataset", "unused.bin", "--model", "llama3-8b", "--fsdp", "2"])
        raise AssertionError("--fsdp 2 on one card did not exit")
    except SystemExit as e:
        message = str(e)
    want = "wants 2 GPUs but only 1 visible"
    if want not in message or torch.cuda.memory_allocated() != before:
        raise AssertionError(f"over-grant: {message!r}, allocated {before} -> "
                             f"{torch.cuda.memory_allocated()}")
    return {"message": message, "bytes_allocated": 0}


def phase_train_tp(fa, bps: float, train: dict | None) -> dict:
    out = {"c_overgrant": train_tp_overgrant(), "a_shards": train_tp_kernels(fa, bps)}
    out["b_mesh"] = train_tp_mesh(fa, train["exact_losses"] if train else None)
    if train:
        out["b_mesh"]["train_step_ms_median_3_8"] = train["step_ms_median_3_8"]
        out["b_mesh"]["train_peak_mem_gb"] = train["peak_mem_gb"]
    return out


def moe_active_params(cfg) -> int:
    """Parameters a token's forward multiplies by: attention, the router and
    its top-k experts in every layer, and the LM head (the embedding is a
    lookup)."""
    H, I = cfg.hidden_size, cfg.intermediate_size
    attn = H * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * H
    experts = cfg.experts_per_token * 3 * H * I
    return cfg.num_layers * (attn + experts + H * cfg.num_experts) + H * cfg.vocab_size


def phase_train_moe(fa) -> dict:
    """MoE training: Mixtral-8x7B at full width and MOE_TRAIN_LAYERS layers
    through create_moe_train_state and make_moe_train_step (the CLI has no
    depth flag), then the CLI's mixtral-tiny branch with a resume."""
    from kukeon_tpu_torch.models import moe
    from kukeon_tpu_torch.training import (
        TokenDataset,
        batches,
        create_moe_train_state,
        make_moe_train_step,
    )
    from kukeon_tpu_torch.training.train_step import cross_entropy_loss, make_optimizer

    cfg = dataclasses.replace(moe.mixtral_8x7b(), num_layers=MOE_TRAIN_LAYERS)
    B, S, steps = MOE_TRAIN_B, MOE_TRAIN_S, MOE_TRAIN_STEPS
    gc.collect()
    torch.cuda.empty_cache()
    free_gb = torch.cuda.mem_get_info()[0] / 1e9
    print(f"train_moe: {free_gb:.2f} GB free on the card at the start", flush=True)
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="kukeon-train-moe-")
    try:
        data = os.path.join(tmp, "tokens.bin")
        zipf_dataset(data, 1_000_000, seed=1, vocab=cfg.vocab_size)
        opt = make_optimizer(3e-4, warmup_steps=1, total_steps=steps)
        t0 = time.monotonic()
        state, opt = create_moe_train_state(
            cfg, torch.Generator(device="cuda").manual_seed(MOE_TRAIN_SEED), "cuda", opt)
        torch.cuda.synchronize()
        init_s = time.monotonic() - t0
        step = make_moe_train_step(cfg, opt)
        feed = list(batches(TokenDataset(data), B, S, num_steps=steps, seed=MOE_TRAIN_SEED,
                            device="cuda"))

        # The same params and first batch through the reference attention,
        # no grad: the loss step 1 must report.
        _s, tok, tgt, mask = feed[0]
        pos = torch.arange(S, device="cuda", dtype=torch.int32)[None, :].expand(B, S).contiguous()
        with torch.no_grad():
            logits, _, aux = moe.forward_with_aux(state.params, cfg, tok, pos,
                                                  attn_impl="reference")
            ref_loss = float(cross_entropy_loss(logits, tgt, mask)
                             + cfg.load_balance_coef * aux["load_balance"]
                             + cfg.router_z_coef * aux["router_z"])
            del logits, aux
        gc.collect()
        torch.cuda.empty_cache()

        rows, step_ms, per_step = [], [], []
        fa.flash_attention.launches = 0
        for _s, tok, tgt, mask in feed:
            before = fa.flash_attention.launches
            torch.cuda.synchronize()
            t0 = time.monotonic()
            state, m = step(state, tok, tgt, mask)
            rows.append({k: float(v) for k, v in m.items()})     # waits for the device
            torch.cuda.synchronize()
            step_ms.append((time.monotonic() - t0) * 1e3)
            per_step.append(fa.flash_attention.launches - before)
            print(f"train_moe: step {len(rows)} loss {rows[-1]['loss']:.4f} "
                  f"lb={rows[-1]['load_balance']:.3f} ({step_ms[-1]:.1f} ms)", flush=True)
        launches = fa.flash_attention.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # One more step (the last batch again) under the profiler.
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            state, m = step(state, tok, tgt, mask)
            float(m["loss"])
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
        profiled = step_breakdown(prof, wall_ms)
        del state, opt, step, feed, prof
        gc.collect()
        torch.cuda.empty_cache()

        tiny = os.path.join(tmp, "tiny.bin")
        zipf_dataset(tiny, 200_000, seed=2, vocab=moe.moe_tiny().vocab_size)
        common = ["--dataset", tiny, "--model", "mixtral-tiny", "--batch", str(TINY_MOE_B),
                  "--seq-len", str(TINY_MOE_S), "--lr", "3e-3", "--warmup-steps", "1",
                  "--log-every", "1", "--ckpt-dir", os.path.join(tmp, "ckpt"),
                  "--save-every", "2"]
        r = cli_train_twice(fa, common, TINY_MOE_STEPS, TINY_MOE_MORE)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    losses = [row["loss"] for row in rows]
    if not all(math.isfinite(v) for row in rows for v in row.values()) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"mixtral train: the loss did not fall: {rows}")
    rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    if rel > 1e-2:
        raise AssertionError(f"mixtral train: step 1's loss {losses[0]} is {rel:.4f} "
                             f"relative from the reference attention's {ref_loss}")
    want = 2 * cfg.num_layers       # forward + remat recompute, every layer
    if per_step != [want] * steps or launches != want * steps:
        raise AssertionError(f"mixtral train: flash launches {per_step}, want {want} a step")
    _run1, _run2, tiny_losses = check_cli_runs(r, TINY_MOE_STEPS, TINY_MOE_MORE, [2, 4])
    if not all("lb=" in ln for ln in (r["first"]["log"] + r["second"]["log"]).splitlines()
               if ln.startswith("step ")):
        raise AssertionError("mixtral-tiny step lines carry no lb=")

    tokens = B * S
    ms = statistics.median(step_ms[2:])
    active = moe_active_params(cfg)
    attn_flops = 3 * cfg.num_layers * flash_flops(B, S, cfg.num_heads, cfg.head_dim)
    flops = 6.0 * active * tokens + attn_flops
    # The dense dispatch runs every expert on all E·C capacity slots,
    # empty ones included, where the active count has K·N.
    C = moe._capacity(cfg, tokens)
    slot_flops = (6.0 * cfg.num_layers * cfg.num_experts * C
                  * 3 * cfg.hidden_size * cfg.intermediate_size)
    return {"model": f"mixtral-8x7b, {cfg.num_layers} layers", "batch": B, "seq_len": S,
            "steps": steps, "params": cfg.param_count(), "active_params": active,
            "free_gb_at_start": round(free_gb, 2), "init_s": round(init_s, 3),
            "reference_attention_loss": ref_loss, "step1_loss": losses[0],
            "step1_rel_diff": rel, "metrics": rows, "losses": losses,
            "step_ms": [round(x, 3) for x in step_ms],
            "step_ms_median_3_6": round(ms, 3),
            "tokens_per_s": round(tokens / ms * 1e3, 1),
            "mfu": round(flops / (ms / 1e3) / BF16_FLOPS, 4),
            "mfu_formula": "(6 * active_params * B * S + 3 * L * 2 * B * H * S^2 * D) / step "
                           "/ 989e12; active: attention, router, top-2 of 8 experts, LM head",
            "mfu_flops_per_step": flops,
            "expert_slot_flops_per_step": slot_flops,
            "expert_active_flops_per_step": (6.0 * cfg.num_layers * cfg.experts_per_token
                                             * tokens * 3 * cfg.hidden_size
                                             * cfg.intermediate_size),
            "capacity": C, "peak_mem_gb": round(peak_gb, 2), "profile": profiled,
            "flash_launches": launches, "flash_launches_per_step": per_step,
            "tiny_cli": {"losses": tiny_losses, "resumed_from": r["restored"]["step"],
                         "restored_params_bitwise_equal": True, "checkpoint_format": "orbax",
                         "saves": r["saves"],
                         "flash_launches": [r["first"]["launches"], r["second"]["launches"]]}}


def moe_one_device_rows(cfg, data: str, steps: int) -> list:
    """train_moe's first ``steps`` metrics, from its init, optimizer and
    batches on one device (when train_moe did not run)."""
    from kukeon_tpu_torch.training import (TokenDataset, batches, create_moe_train_state,
                                           make_moe_train_step)
    from kukeon_tpu_torch.training.train_step import make_optimizer

    opt = make_optimizer(3e-4, warmup_steps=1, total_steps=MOE_TRAIN_STEPS)
    state, opt = create_moe_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(MOE_TRAIN_SEED), "cuda", opt)
    step = make_moe_train_step(cfg, opt)
    rows = []
    for _s, *batch in batches(TokenDataset(data), MOE_TRAIN_B, MOE_TRAIN_S, num_steps=steps,
                              seed=MOE_TRAIN_SEED, device="cuda"):
        state, m = step(state, *batch)
        rows.append({k: float(v) for k, v in m.items()})
    del state, step
    return rows


def train_moe_mesh(fa, want: list | None) -> dict:
    """(b): train_moe's Mixtral-8x7B cut through MeshTrainer (``cfg=``) on
    a one-rank NCCL group, MOE_TP_STEPS steps of train_moe's configuration
    (seed, lr 3e-4, warmup 1, total MOE_TRAIN_STEPS, its Zipf dataset): the
    metrics against ``want`` (train_moe's; None: moe_one_device_rows) bit
    for bit, flash launches a step (the counter set to 0 just before the
    steps), ms a step and peak memory; the group shut down after."""
    import torch.distributed as dist

    from kukeon_tpu_torch.models import moe
    from kukeon_tpu_torch.parallel import launch
    from kukeon_tpu_torch.parallel.mesh import make_mesh
    from kukeon_tpu_torch.parallel.sharding import TrainLayout
    from kukeon_tpu_torch.training.mesh_trainer import MeshTrainer

    cfg = dataclasses.replace(moe.mixtral_8x7b(), num_layers=MOE_TRAIN_LAYERS)
    tmp = tempfile.mkdtemp(prefix="kukeon-train-moe-tp-")
    try:
        data = os.path.join(tmp, "tokens.bin")
        zipf_dataset(data, 1_000_000, seed=1, vocab=cfg.vocab_size)
        if want is None:
            want = moe_one_device_rows(cfg, data, MOE_TP_STEPS)
            gc.collect()
            torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mesh = make_mesh(device="cuda")
        backend = dist.get_backend()
        if mesh.size != 1 or launch.current() is None or backend != "nccl":
            raise AssertionError(f"make_mesh() on one card: {mesh}, backend {backend}")
        t0 = time.monotonic()
        tr = MeshTrainer(mesh, model="mixtral-8x7b", cfg=cfg, dataset=data, batch=MOE_TRAIN_B,
                         seq_len=MOE_TRAIN_S, seed=MOE_TRAIN_SEED, lr=3e-4, warmup_steps=1,
                         total_steps=MOE_TRAIN_STEPS)
        torch.cuda.synchronize()
        init_s = time.monotonic() - t0
        fa.flash_attention.launches = 0
        rows, step_ms = [], []
        for i in range(MOE_TP_STEPS):
            t0 = time.monotonic()
            rows.append({k: float(v) for k, v in tr.step(i).items()})   # waits for the device
            step_ms.append((time.monotonic() - t0) * 1e3)
        launches = fa.flash_attention.launches
        peak = torch.cuda.max_memory_allocated()
        tr.close()
        del tr
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        launch.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    per_step = 2 * cfg.num_layers
    if rows != want[:MOE_TP_STEPS]:
        raise AssertionError(f"MoE mesh trainer metrics {rows} differ from train_moe's "
                             f"{want[:MOE_TP_STEPS]}")
    if launches != per_step * MOE_TP_STEPS:
        raise AssertionError(f"MoE mesh trainer: {launches} flash launches, want {per_step} "
                             "a step")
    full = moe.mixtral_8x7b()
    state_gb = {name: round(TrainLayout(full, 0, f, 0, 1, expert_rank=0, expert=x)
                            .state_bytes() / 1e9, 3)
                for name, f, x in (("one_device", 1, 1), ("expert8", 1, 8),
                                   ("fsdp4_expert2", 4, 2))}
    return {"model": f"mixtral-8x7b, {cfg.num_layers} layers", "batch": MOE_TRAIN_B,
            "seq_len": MOE_TRAIN_S, "backend": backend, "metrics": rows,
            "metrics_equal_train_moe": True, "init_s": round(init_s, 3),
            "step_ms": [round(x, 3) for x in step_ms],
            "step_ms_median_2_3": round(statistics.median(step_ms[1:]), 3),
            "peak_mem_gb": round(peak / 1e9, 2), "flash_launches": launches,
            "flash_launches_per_step": launches // MOE_TP_STEPS,
            "mixtral-8x7b_rank_state_gb": state_gb}


def train_moe_tp_overgrant() -> dict:
    """(c): the CLI with --expert 2 on one card exits with the over-grant
    message, and no byte reaches the card."""
    from kukeon_tpu_torch.training import cli

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    try:
        cli.main(["--dataset", "unused.bin", "--model", "mixtral-8x7b", "--expert", "2"])
        raise AssertionError("--expert 2 on one card did not exit")
    except SystemExit as e:
        message = str(e)
    want = "wants 2 GPUs but only 1 visible"
    if want not in message or torch.cuda.memory_allocated() != before:
        raise AssertionError(f"over-grant: {message!r}, allocated {before} -> "
                             f"{torch.cuda.memory_allocated()}")
    return {"message": message, "bytes_allocated": 0}


def phase_train_moe_tp(fa, bps: float, train_moe: dict | None) -> dict:
    out = {"c_overgrant": train_moe_tp_overgrant(),
           "a_shards": train_tp_kernels(fa, bps, B=MOE_TRAIN_B, layers=32)}
    out["b_mesh"] = train_moe_mesh(fa, train_moe["metrics"] if train_moe else None)
    if train_moe:
        out["b_mesh"]["train_moe_step_ms_median_3_6"] = train_moe["step_ms_median_3_6"]
        out["b_mesh"]["train_moe_step_ms_1_3"] = train_moe["step_ms"][:MOE_TP_STEPS]
        out["b_mesh"]["train_moe_peak_mem_gb"] = train_moe["peak_mem_gb"]
    return out


# train_sp_pp: (a) a llama3-1b seq rank's ring at S SP_S over SP_SEQ ranks
# (blocks of SP_S / SP_SEQ queries and keys, H 32, KV 8, D 64) and
# Ulysses' local attention (H 32 / SP_SEQ, KV 8 / SP_SEQ, the whole S);
# (b) train's configuration through the GPipe step on one rank, PP_STEPS
# steps at PP_MICROBATCHES microbatches.
SP_S, SP_SEQ, SP_H, SP_KV, SP_D = 8192, 4, 32, 8, 64
PP_STEPS, PP_MICROBATCHES = 3, 2
# (b)'s losses against train's: the pipeline runs two microbatches of two
# rows where train runs four rows at once, so bf16 products of other
# shapes (other GEMM tilings) and the gradient summed over two backwards in
# bf16. On an H100 the sound step reads 0, 7.7e-8 and 5.4e-5 relative at
# steps 1-3; with the first microbatch's backward skipped, or counted
# twice, step 3 reads 3.0e-2 or 2.0e-2 (tools/pp_loss_gate.py). The limit
# sits about 20x from each.
PP_LOSS_RTOL = 1e-3


# The flash kernel's shapes in a GPipe stage, each a microbatch's rows at
# S 2048: (key, what runs it, B, H, KV, D, launches a rank's step).
PP_FLASH_SHAPES = (
    ("b_llama3_1b_m2", "(b): llama3-1b, 2 microbatches of B 4, 16 layers", 2, 32, 8, 64, 32),
    ("llama3_1b_m4", "llama3-1b at pipe 4 (4 layers a stage) or pipe 2 x data 2 (8 layers, "
     "2 of the 4 microbatches a rank), M 4 of B 4", 1, 32, 8, 64, 16),
    ("llama3_1b_m4_t2", "llama3-1b at pipe 2 x tensor 2, M 4 of B 4, 8 layers a stage", 1, 16,
     4, 64, 32),
    ("llama3_8b_m8", "llama3-8b at pipe 4, M 8 of B 8, 8 layers a stage", 1, 32, 8, 128, 64),
)


def pp_flash_kernels(fa, bps: float) -> dict:
    """(a): the flash kernel at each shape a GPipe stage gives it
    (PP_FLASH_SHAPES: a microbatch's rows, a rank's heads) against its
    plain version (:func:`flash_at_shape`)."""
    g = torch.Generator(device="cuda").manual_seed(26)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    out = {key: {**flash_at_shape(fa, g, flush, bps, B, TRAIN_S, H, KV, D, what),
                 "runs_in": what, "launches_per_rank_step": n}
           for key, what, B, H, KV, D, n in PP_FLASH_SHAPES}
    del flush
    return {"shapes": out, "max_abs_err": max(r["max_abs_err"] for r in out.values()),
            "library_call": "torch.nn.functional.scaled_dot_product_attention"
                            "(is_causal=True) on expanded K/V",
            "tolerance": FLASH_TOLERANCE}


def ring_timings(fn_fwd, fn_both, flush: torch.Tensor, ops: float) -> dict:
    """Cold ms and device ms of a forward and of a forward and backward,
    beside their bounds at the bf16 rate (the backward's four products
    twice the forward's two: 3x its operations in all)."""
    out = {}
    for name, fn, n in (("fwd", fn_fwd, ops), ("fwd_bwd", fn_both, 3 * ops)):
        out[name] = {"ms": round(cold_median_ms(fn, flush, runs=10), 4),
                     "device_ms": round(sum(kernel_device_ms(fn, flush, calls=3).values()), 4),
                     "bound_ms": round(n / BF16_FLOPS * 1e3, 4), "bound_by": "operations"}
    return out


def ring_assembly() -> dict:
    """(a): the ring body (``parallel/ring_attention.py``'s block update)
    of a llama3-1b seq rank at S SP_S over SP_SEQ ranks, on one card: the
    SP_SEQ query blocks' online-softmax updates over every kv block in
    ring order (rank i holds block (i - j) mod SP_SEQ at step j), against
    one whole causal attention over the S positions in f32 (the plain
    reference attention of the upcast inputs, a query block at a time).
    The ring computes in f32 and rounds its output to bf16 once, so every
    element within half a bf16 ulp, 2^-8 of its magnitude, plus 1e-5 of
    max|v| for the f32 sums' order. Then, ungated: one full block update
    (2048 queries against 2048 earlier keys) forward and forward and
    backward, beside SDPA on the same block (K/V expanded, no mask); and
    Ulysses' local attention (``attention_reference`` over the whole S at
    H 32 / SP_SEQ, KV 8 / SP_SEQ, causal) beside causal SDPA."""
    import torch.nn.functional as F

    from kukeon_tpu_torch.ops.attention import (NEG_INF, attention_mask,
                                                attention_reference, repeat_kv)
    from kukeon_tpu_torch.parallel.ring_attention import block_update, finish

    g = torch.Generator(device="cuda").manual_seed(25)
    S, n, H, KV, D = SP_S, SP_SEQ, SP_H, SP_KV, SP_D
    blk, rep, scale = S // n, H // KV, 1.0 / math.sqrt(D)
    q, k, v = (torch.randn((1, S, h, D), generator=g, device="cuda").to(torch.bfloat16)
               for h in (H, KV, KV))
    pos = torch.arange(S, device="cuda", dtype=torch.int32)[None, :]

    def fresh():
        return (torch.zeros((1, blk, H, D), device="cuda"),
                torch.full((1, H, blk), NEG_INF, device="cuda"),
                torch.zeros((1, H, blk), device="cuda"))

    ke, ve = repeat_kv(k, rep).float(), repeat_kv(v, rep).float()
    worst, rel = 0.0, 0.0
    ok = True
    with torch.no_grad():
        for i in range(n):
            qs = slice(i * blk, (i + 1) * blk)
            o, m, l = fresh()
            for j in range(n):
                b = (i - j) % n
                ks = slice(b * blk, (b + 1) * blk)
                o, m, l = block_update(o, m, l, q[:, qs], k[:, ks], v[:, ks], pos[:, qs],
                                       pos[:, ks], scale)
            got = finish(o, l, q.dtype).float()
            ref = attention_reference(q[:, qs].float(), ke, ve,
                                      attention_mask(pos[:, qs], pos))
            err = (got - ref).abs()
            ok = ok and bool(torch.all(err <= 2.0 ** -8 * ref.abs()
                                       + 1e-5 * v.float().abs().max()))
            ok = ok and bool(torch.isfinite(got).all())
            worst = max(worst, float(err.max()))
            rel = max(rel, float(err.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()))
            del o, m, l, got, ref, err
    del ke, ve
    if not ok:
        raise AssertionError(f"ring assembly at S {S} over {n} blocks: max abs {worst} "
                             "past 2^-8 |ref| + 1e-5 max|v|")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    # One full block: queries of block 1 against the keys of block 0.
    qb, kb, vb = q[:, blk:2 * blk], k[:, :blk], v[:, :blk]
    pq, pk = pos[:, blk:2 * blk], pos[:, :blk]
    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (qb, kb, vb))
    go = torch.randn((1, blk, H, D), generator=g, device="cuda").to(torch.bfloat16)

    def ring_fwd():
        with torch.no_grad():
            return block_update(*fresh(), qb, kb, vb, pq, pk, scale)

    def ring_both():
        o, _m, l = block_update(*fresh(), qg, kg, vg, pq, pk, scale)
        finish(o, l, qg.dtype).backward(go)

    qt, kt, vt = (x.transpose(1, 2) for x in (qb, repeat_kv(kb, rep), repeat_kv(vb, rep)))
    qtg, ktg, vtg = (x.detach().clone().requires_grad_(True) for x in (qt, kt, vt))
    got = {"shape": [1, blk, H, KV, D], "blocks": n,
           "ring_block": ring_timings(ring_fwd, ring_both, flush, 4.0 * blk * blk * D * H),
           "ring_block_sdpa": ring_timings(
               lambda: F.scaled_dot_product_attention(qt, kt, vt),
               lambda: F.scaled_dot_product_attention(qtg, ktg, vtg).backward(
                   go.transpose(1, 2)), flush, 4.0 * blk * blk * D * H)}
    del qg, kg, vg, qtg, ktg, vtg
    # Ulysses' local body: the whole sequence on H / n heads.
    h, kvh = H // n, KV // n
    qu, ku, vu = q[:, :, :h], k[:, :, :kvh], v[:, :, :kvh]
    mask = attention_mask(pos, pos)
    qug, kug, vug = (x.detach().clone().requires_grad_(True) for x in (qu, ku, vu))
    gu = torch.randn((1, S, h, D), generator=g, device="cuda").to(torch.bfloat16)

    def ulysses(a, b, c):
        return attention_reference(a, repeat_kv(b, h // kvh), repeat_kv(c, h // kvh), mask)

    def ulysses_fwd():
        with torch.no_grad():
            return ulysses(qu, ku, vu)

    qs_, ks_, vs_ = (x.transpose(1, 2) for x in (qu, repeat_kv(ku, h // kvh),
                                                 repeat_kv(vu, h // kvh)))
    qsg, ksg, vsg = (x.detach().clone().requires_grad_(True) for x in (qs_, ks_, vs_))
    got["ulysses_local"] = {"shape": [1, S, h, kvh, D], **ring_timings(
        ulysses_fwd, lambda: ulysses(qug, kug, vug).backward(gu), flush,
        flash_flops(1, S, h, D))}
    got["ulysses_local_sdpa"] = ring_timings(
        lambda: F.scaled_dot_product_attention(qs_, ks_, vs_, is_causal=True),
        lambda: F.scaled_dot_product_attention(qsg, ksg, vsg, is_causal=True).backward(
            gu.transpose(1, 2)), flush, flash_flops(1, S, h, D))
    del flush
    return {"max_abs_err": worst, "rel_rms_err": rel,
            "tolerance": "|err| <= 2^-8 |ref| + 1e-5 max|v| (one bf16 rounding of an f32 "
                         "result) against f32 causal attention", **got,
            "library_call": "torch.nn.functional.scaled_dot_product_attention"}


def train_pp_mesh(fa, want: list | None) -> dict:
    """(b): llama3-1b through MeshTrainer's GPipe step (``num_microbatches``
    PP_MICROBATCHES) on a one-rank NCCL group, PP_STEPS steps of train's
    configuration (seed 0, lr 3e-4, warmup 1, total TRAIN_STEPS, its Zipf
    dataset): each loss's relative gap from ``want``'s (train's exact
    losses; None: one_device_losses), which :func:`check_pp_losses` holds
    to PP_LOSS_RTOL, K3 launches a step (no remat: one a
    layer a microbatch; the counter set to 0 just before the steps), ms a
    step and peak memory; the group shut down after."""
    import torch.distributed as dist

    from kukeon_tpu_torch.models import llama
    from kukeon_tpu_torch.parallel import launch
    from kukeon_tpu_torch.parallel.mesh import make_mesh
    from kukeon_tpu_torch.parallel.sharding import TrainLayout
    from kukeon_tpu_torch.training.mesh_trainer import MeshTrainer

    cfg = llama.llama3_1b()
    tmp = tempfile.mkdtemp(prefix="kukeon-train-pp-")
    try:
        data = os.path.join(tmp, "tokens.bin")
        zipf_dataset(data, 4_000_000, seed=0)
        if want is None:
            want = one_device_losses(data, PP_STEPS)
            gc.collect()
            torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mesh = make_mesh(device="cuda")
        backend = dist.get_backend()
        if mesh.size != 1 or launch.current() is None or backend != "nccl":
            raise AssertionError(f"make_mesh() on one card: {mesh}, backend {backend}")
        t0 = time.monotonic()
        tr = MeshTrainer(mesh, model="llama3-1b", dataset=data, batch=TRAIN_B,
                         seq_len=TRAIN_S, seed=0, lr=3e-4, warmup_steps=1,
                         total_steps=TRAIN_STEPS, num_microbatches=PP_MICROBATCHES)
        if not tr.pipeline:
            raise AssertionError("num_microbatches did not select the GPipe step")
        init_s = time.monotonic() - t0
        fa.flash_attention.launches = 0
        losses, step_ms = [], []
        for i in range(PP_STEPS):
            t0 = time.monotonic()
            losses.append(float(tr.step(i)))             # waits for the device
            step_ms.append((time.monotonic() - t0) * 1e3)
        launches = fa.flash_attention.launches
        peak = torch.cuda.max_memory_allocated()
        tr.close()
        del tr
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        launch.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, want[:PP_STEPS])]
    per_step = cfg.num_layers * PP_MICROBATCHES
    if launches != per_step * PP_STEPS:
        raise AssertionError(f"pipeline step: {launches} flash launches, want {per_step} "
                             "a step")
    cfg8 = llama.llama3_8b()
    state_gb = {f"pipe4_stage{p}": round(TrainLayout(cfg8, 0, 1, 0, 1, pipe_rank=p, pipe=4,
                                                     pipeline=True).state_bytes() / 1e9, 3)
                for p in (0, 3)}
    return {"model": "llama3-1b", "batch": TRAIN_B, "seq_len": TRAIN_S,
            "microbatches": PP_MICROBATCHES, "backend": backend, "losses": losses,
            "train_losses": want[:PP_STEPS], "loss_rel_diff": rel,
            "loss_rtol": PP_LOSS_RTOL, "init_s": round(init_s, 3),
            "step_ms": [round(x, 3) for x in step_ms],
            "step_ms_median_2_3": round(statistics.median(step_ms[1:]), 3),
            "peak_mem_gb": round(peak / 1e9, 2), "flash_launches": launches,
            "flash_launches_per_step": launches // PP_STEPS,
            "llama3-8b_rank_state_gb": state_gb}


def check_pp_losses(out: dict) -> None:
    """(b)'s gate: each of the pipeline's PP_STEPS losses within
    PP_LOSS_RTOL of train's."""
    rel = out["loss_rel_diff"]
    if len(rel) != PP_STEPS or max(rel) > PP_LOSS_RTOL:
        raise AssertionError(f"pipeline losses {out['losses']} against train's "
                             f"{out['train_losses']}: relative {rel} past {PP_LOSS_RTOL}")


def train_sp_pp_overgrant() -> dict:
    """(c): the CLI with --seq 2, and with --pipe 2, on one card exits with
    the over-grant message, and no byte reaches the card."""
    from kukeon_tpu_torch.training import cli

    out = {}
    for axis in ("seq", "pipe"):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        try:
            cli.main(["--dataset", "unused.bin", "--model", "llama3-1b", f"--{axis}", "2"])
            raise AssertionError(f"--{axis} 2 on one card did not exit")
        except SystemExit as e:
            message = str(e)
        if ("wants 2 GPUs but only 1 visible" not in message
                or torch.cuda.memory_allocated() != before):
            raise AssertionError(f"over-grant: {message!r}, allocated {before} -> "
                                 f"{torch.cuda.memory_allocated()}")
        out[axis] = {"message": message, "bytes_allocated": 0}
    return out


def phase_train_sp_pp(fa, bps: float, train: dict | None) -> dict:
    out = {"c_overgrant": train_sp_pp_overgrant(), "a_ring": ring_assembly(),
           "a_stage_flash": pp_flash_kernels(fa, bps)}
    gc.collect()
    torch.cuda.empty_cache()
    out["b_pipeline"] = train_pp_mesh(fa, train["exact_losses"] if train else None)
    check_pp_losses(out["b_pipeline"])
    if train:
        out["b_pipeline"]["train_step_ms_median_3_8"] = train["step_ms_median_3_8"]
        out["b_pipeline"]["train_peak_mem_gb"] = train["peak_mem_gb"]
    return out


# train_moe_sp: the (data, seq) meshes whose ranks' dispatch is held to
# the whole batch's, and the seed of the router and the activations.
MOE_SP_MESHES, MOE_SP_SEED = ((1, 4), (2, 2)), 5
# train_moe_sp (b): a Mixtral-8x7B seq rank's rows and the seq sizes whose
# ranks attend (seq 2 x expert 2 and seq 4 on four GPUs give a rank B 4).
SEQ_FLASH_B, SEQ_FLASH_SEQS = 4, (2, 4)


def seq_flash(fa, bps: float) -> dict:
    """(b): ``llama.seq_attention`` with "auto", the attention of a
    training rank on a ``seq`` axis in both families, at a Mixtral-8x7B
    seq rank's shapes (B SEQ_FLASH_B, S MOE_TRAIN_S, H 32, KV 8, D 128,
    bf16) for each rank of each seq in SEQ_FLASH_SEQS, through a stand-in
    mesh whose gather checks that it is given the rank's block of keys,
    values or positions and returns the whole sequence's. The flash
    counter is set to 0 just before the ranks' calls and must read one
    launch a rank after them (the rank's S / seq queries against all S
    keys); each rank's output is held against the plain version (its
    queries over every key) by :func:`flash_within_tol`. The last rank's
    block, the heaviest, is timed: the kernel, the plain version and SDPA
    with the boolean mask of its positions, beside the block's bound."""
    from types import SimpleNamespace

    import torch.nn.functional as F

    from kukeon_tpu_torch.models import llama, moe
    from kukeon_tpu_torch.ops.attention import attention_mask, repeat_kv
    from kukeon_tpu_torch.parallel.mesh import AXIS_SEQ

    cfg = moe.mixtral_8x7b()
    B, S, H, KV, D = SEQ_FLASH_B, MOE_TRAIN_S, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(MOE_SP_SEED)
    q, k, v = (torch.randn((B, S, n, D), generator=g, device="cuda").to(torch.bfloat16)
               for n in (H, KV, KV))
    pos = torch.arange(S, device="cuda", dtype=torch.int32)[None, :].expand(B, S).contiguous()
    out = {}
    for seq in SEQ_FLASH_SEQS:
        cols = S // seq
        blocks = [slice(r * cols, (r + 1) * cols) for r in range(seq)]

        def stand_in(rank):
            def gather(x, dim, axis):
                whole = {k.data_ptr(): k, v.data_ptr(): v, pos.data_ptr(): pos}[
                    x.untyped_storage().data_ptr()]
                if (dim, axis) != (1, AXIS_SEQ) or not torch.equal(x, whole[:, blocks[rank]]):
                    raise AssertionError(f"seq {seq} rank {rank}: gather given another block")
                return whole
            return SimpleNamespace(seq=seq, axis_size=lambda axis: seq, gather=gather)

        with torch.no_grad():
            fa.flash_attention.launches = 0
            got = [llama.seq_attention(q[:, c], k[:, c], v[:, c], pos[:, c], "auto",
                                       stand_in(r)) for r, c in enumerate(blocks)]
            launches = fa.flash_attention.launches
            worst, rel = 0.0, 0.0
            for r, c in enumerate(blocks):
                ref = fa.flash_attention_reference(q[:, c], k, v, pos[:, c], pos)
                ok, ea, er = flash_within_tol(got[r], ref, v)
                if not ok:
                    raise AssertionError(f"seq {seq} rank {r}: max abs {ea}, rel rms {er}")
                worst, rel = max(worst, ea), max(rel, er)
        if launches != seq:
            raise AssertionError(f"seq {seq}: {launches} flash launches for {seq} ranks")
        del got
        out[f"seq={seq}"] = {"shape": [B, cols, S, H, KV, D], "launches": launches,
                             "max_abs_err": worst, "rel_rms_err": rel}
    # The heaviest block: the last rank's queries of the last seq.
    c = blocks[-1]
    qb, pb = q[:, c].contiguous(), pos[:, c].contiguous()
    call = (lambda: fa.flash_attention(qb, k, v, pb, pos))
    mask = attention_mask(pb, pos)
    qt, kt, vt = (x.transpose(1, 2) for x in (qb, repeat_kv(k, H // KV), repeat_kv(v, H // KV)))
    pairs = float(torch.clamp(pb[0].double() + 1, max=S).sum())   # keys a query sees
    t_ops = 4.0 * B * H * D * pairs / BF16_FLOPS * 1e3
    t_bytes = (2 * B * cols * H * D + 2 * B * S * KV * D) * 2 / bps * 1e3
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    with torch.no_grad():
        before = fa.flash_attention.launches
        timing = {
            "shape": [B, cols, S, H, KV, D], "rows": [c.start, c.stop],
            "ms": round(cold_median_ms(call, flush), 4),
            "plain_ms": round(cold_median_ms(
                lambda: fa.flash_attention_reference(qb, k, v, pb, pos), flush), 4),
            "library_ms": round(cold_median_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), flush), 4),
            "device_ms": round(sum(kernel_device_ms(call, flush).values()), 4),
            "bound_ms": round(max(t_ops, t_bytes), 4),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        fa.flash_attention.launches = before
    del flush
    return {"ranks": out, "timing_last_block": timing, "tolerance": FLASH_TOLERANCE,
            "library_call": "torch.nn.functional.scaled_dot_product_attention(attn_mask=the "
                            "block's position mask) on expanded K/V"}


def phase_train_moe_sp(fa, bps: float) -> dict:
    """train_moe_sp: one full-width Mixtral-8x7B MoE layer's routing of
    train_moe's batch (B MOE_TRAIN_B, S MOE_TRAIN_S; router and bf16
    activations drawn from MOE_SP_SEED), dispatched by one device for the
    whole batch and by each rank of MOE_SP_MESHES for its block of rows and
    positions (moe._row_offsets over a stand-in mesh whose gather checks
    that it is given the rank's own per-row counts and returns every
    rank's, ranks in AXES order), at the preset's capacity_factor and at
    1.0: every rank's dispatch its block of the whole, bit for bit, and
    something dropped at 1.0; then (b), :func:`seq_flash`."""
    from types import SimpleNamespace

    from kukeon_tpu_torch.models import moe

    cfg = moe.mixtral_8x7b()
    B, S, H = MOE_TRAIN_B, MOE_TRAIN_S, cfg.hidden_size
    E, K = cfg.num_experts, cfg.experts_per_token
    g = torch.Generator(device="cuda").manual_seed(MOE_SP_SEED)
    router = torch.randn((H, E), generator=g, device="cuda").mul_(H ** -0.5)
    h = torch.randn((B * S, H), generator=g, device="cuda").to(torch.bfloat16)
    mask = moe._route(h, {"router": router}, cfg)[3].reshape(K, B, S, E)
    out = {"model": "mixtral-8x7b MoE layer", "batch": B, "seq_len": S,
           "first_choice_tokens_by_expert": mask[0].sum(dim=(0, 1)).int().tolist()}
    for cf in (cfg.capacity_factor, 1.0):
        C = moe._capacity(dataclasses.replace(cfg, capacity_factor=cf), B * S)
        whole = moe._dispatch(mask.reshape(K, B * S, E), C).reshape(B, S, E, C)
        dropped = 1.0 - float(whole.sum()) / (K * B * S)
        meshes = {}
        for data, seq in MOE_SP_MESHES:
            rows, cols = B // data, S // seq
            blocks = [(d, s, slice(d * rows, (d + 1) * rows), slice(s * cols, (s + 1) * cols))
                      for d in range(data) for s in range(seq)]
            every = torch.stack([mask[:, r, c].sum(dim=2) for _d, _s, r, c in blocks])

            def gather(i):
                def fn(x, dim, axis):
                    if (dim, axis) != (0, "batch") or not torch.equal(x[0], every[i]):
                        raise AssertionError(f"data={data},seq={seq} rank {i}: gather given "
                                             "other counts than the rank's own")
                    return every
                return fn

            for i, (d, s, r, c) in enumerate(blocks):
                mesh = SimpleNamespace(axis_size=lambda axis: len(blocks), seq=seq, seq_rank=s,
                                       replica=d, fsdp=1, fsdp_rank=0, gather=gather(i))
                part = mask[:, r, c].reshape(K, rows * cols, E)
                got = moe._dispatch(part, C, moe._row_offsets(part, mesh, rows))
                if not torch.equal(got, whole[r, c].reshape(rows * cols, E, C)):
                    raise AssertionError(f"data={data},seq={seq} rank (data {d}, seq {s}) at "
                                         f"capacity_factor {cf}: its dispatch is not its block "
                                         "of the whole batch's")
            meshes[f"data={data},seq={seq}"] = {"ranks": len(blocks), "rows": rows,
                                                "positions": cols, "bitwise_equal": True}
        if cf == 1.0 and not dropped > 0:
            raise AssertionError("capacity_factor 1.0 dropped nothing: the check binds no slot")
        out[f"capacity_factor_{cf}"] = {"capacity": C, "dropped_share": round(dropped, 6),
                                        "meshes": meshes}
    del router, h, mask, whole
    out["b_seq_flash"] = seq_flash(fa, bps)
    return out


GRANT_OWNER = "chip_smoke/gpu_grants"
# What a child process under a grant's env prints: its device count and
# device 0's UUID.
GRANT_CHILD = ("import torch\n"
               "n = torch.cuda.device_count()\n"
               "print(n, torch.cuda.get_device_properties(0).uuid if n else '-')\n")


def smi_minors() -> list:
    """Each GPU's minor number in nvidia-smi's index order, from
    ``nvidia-smi -q`` (NVML's own view; None where it shows none)."""
    out = []
    text = subprocess.run(["nvidia-smi", "-q"], capture_output=True, text=True).stdout
    for line in text.splitlines():
        if re.match(r"GPU\b", line):
            out.append(None)
        elif out and line.strip().startswith("Minor Number"):
            minor = line.split(":", 1)[1].strip()
            out[-1] = int(minor) if minor.isdigit() else None
    return out


def granted_child(env: dict) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", GRANT_CHILD], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env={**os.environ, **env})


def phase_gpu_grants() -> dict:
    """gpu_grants: runtime/devices.py on this host: discovery against
    ``nvidia-smi -L``, a grant of 1 GPU persisted and read back by a second
    manager, an over-grant refused, the grant's device nodes present, and a
    child under the grant's visibility_env seeing exactly the granted GPU:
    one device, whose UUID is nvidia-smi's for the GPU of the granted
    minor number (nvidia-smi -q's Minor Number gives its index), or, where
    nvidia-smi hides UUIDs and the host has one GPU, this process's. A
    second child under the minor number taken as a CUDA ordinal, the env a
    manager that assumed the numberings agree would give, is reported
    beside it."""
    from kukeon_tpu_torch.runtime import devices
    from kukeon_tpu_torch.runtime.errors import FailedPrecondition
    from kukeon_tpu_torch.runtime.metadata import MetadataStore

    found = devices.discover_gpus()
    listed = [ln for ln in subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                                          text=True).stdout.splitlines() if ln.startswith("GPU ")]
    if not found or len(found) != len(listed):
        raise AssertionError(f"discover_gpus() {found} against nvidia-smi -L's {len(listed)}")
    uuids = [ln.split(",")[1].strip() for ln in subprocess.run(
        ["nvidia-smi", "--query-gpu=index,uuid", "--format=csv,noheader"], capture_output=True,
        text=True).stdout.splitlines()]
    minors = smi_minors()
    tmp = tempfile.mkdtemp(prefix="kukeon-grants-")
    try:
        mgr = devices.GPUDeviceManager(MetadataStore(tmp))
        grant = mgr.allocate(GRANT_OWNER, 1)
        kept = devices.GPUDeviceManager(MetadataStore(tmp)).allocated()
        if len(grant) != 1 or kept != {grant[0]: GRANT_OWNER}:
            raise AssertionError(f"grant {grant} read back by a second manager as {kept}")
        try:
            mgr.allocate("chip_smoke/too_many", len(found))
            raise AssertionError(f"{len(found)} GPUs granted with one of them taken")
        except FailedPrecondition as e:
            refused = str(e)
        env = mgr.visibility_env(grant)
        nodes = mgr.device_nodes(grant)
        if not nodes or not all(os.path.exists(n) for n in nodes):
            raise AssertionError(f"device nodes {nodes} of grant {grant}")
        t0 = time.monotonic()
        naive_env = {"CUDA_VISIBLE_DEVICES": str(grant[0])}
        child, naive = granted_child(env), granted_child(naive_env)
        outs = [(p.communicate(timeout=300), p.returncode) for p in (child, naive)]
        child_s = time.monotonic() - t0
        mgr.release(GRANT_OWNER)
        released = mgr.allocated()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    (out, err), code = outs[0]
    if code != 0:
        raise AssertionError(f"the granted child exited {code}: {err[-600:]}")
    count, seen = out.split()[-2:]
    minor = grant[0]
    index = minors.index(minor) if minor in minors else (0 if len(listed) == 1 else None)
    hidden = index is not None and not re.fullmatch(r"GPU-[0-9a-fA-F-]{36}", uuids[index])
    if hidden and len(listed) == 1:
        want, source = str(torch.cuda.get_device_properties(0).uuid), "this process (one GPU)"
    elif index is not None and not hidden:
        want, source = uuids[index], "nvidia-smi"
    else:
        raise AssertionError(f"cannot tell the UUID of minor {minor}: nvidia-smi's minors "
                             f"{minors}, UUIDs {uuids}")
    norm = lambda u: u.lower().removeprefix("gpu-")  # noqa: E731
    if int(count) != 1 or norm(seen) != norm(want) or released:
        raise AssertionError(f"grant {grant} (env {env}): the child sees {count} device(s), "
                             f"UUID {seen}, want {want} ({source}); after release {released}")
    (naive_out, _e), naive_code = outs[1]
    return {"gpu_nodes": sorted(n for n in os.listdir("/dev") if re.fullmatch(r"nvidia\d+", n)),
            "discovered": found, "nvidia_smi_listed": len(listed), "grant": grant,
            "persisted_and_read_back": True, "over_grant_refused": refused,
            "visibility_env": env, "device_nodes": nodes, "child_device_count": int(count),
            "child_uuid": seen, "uuid_from": source, "children_s": round(child_s, 3),
            "numberings": {"minor": minor, "nvidia_smi_index": index,
                           "cuda_ordinal_in_env": env["CUDA_VISIBLE_DEVICES"]},
            "minor_as_cuda_ordinal": {"env": naive_env, "exit_code": naive_code,
                                      "device_count": (naive_out.split() or ["-"])[0]},
            "parent_cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}


TP_WORLDS = (2, 4, 8)


def tp_shard_shapes(t: int) -> dict:
    """(K, N, calls a decode step, transposed) of one rank's K1 and K1t
    calls at tensor parallelism t: the llama3-8b projections cut as
    parallel/sharding.py cuts them (column-parallel on N, row-parallel on
    K, the LM head on its vocabulary columns) and the llama3-1b tied head on
    its vocabulary rows, each head's shard padded to the kernel's 128-wide
    tiles as pad_vocab pads it (128256 / 4 = 32064 -> 32128, / 8 = 16032
    -> 16128)."""
    from kukeon_tpu_torch.parallel.sharding import VOCAB_TILE

    def vocab(n: int) -> int:          # pad_vocab's padding of a head shard
        return n + -n % VOCAB_TILE

    out = {}
    for name, (K, N, n) in SHAPES_8B.items():
        row = name in ("wo", "w_down")
        cols = vocab(N // t) if name == "lm_head" else N if row else N // t
        out[name] = (K // t if row else K, cols, n, False)
    out["tied_head_1b"] = (TIED_1B[0], vocab(TIED_1B[1] // t), 1, True)
    return out


def serve_tp_kernels(k1, bps: float) -> dict:
    """(a): every shard shape for t in TP_WORLDS, B 4, against the plain
    version; the route each call takes, cold-L2 kernel and plain ms, the
    kernel's device ms, and one rank's K1 sum for an 8B step beside its
    bound."""
    g = torch.Generator(device="cuda").manual_seed(19)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    out, worst = {}, 0.0
    for t in TP_WORLDS:
        rows = {}
        for name, (K, N, n, transpose) in tp_shard_shapes(t).items():
            q = torch.randint(-127, 128, (N, K) if transpose else (K, N), generator=g,
                              device="cuda", dtype=torch.int8)
            s = torch.rand(N, generator=g, device="cuda") * 0.02 + 1e-3
            h = torch.randn((4, K), generator=g, device="cuda").to(torch.bfloat16)
            route = k1._route("cuda", 4, K, N)
            before = k1.int8_matmul.launches
            got = k1.int8_matmul(h, q, s, transpose=transpose)
            launched = k1.int8_matmul.launches - before
            ref = k1.int8_matmul_reference(h, q, s, transpose=transpose)
            torch.cuda.synchronize()
            ok, ea, er = within_tol(got, ref)
            if not ok or not torch.isfinite(got).all():
                raise AssertionError(f"int8_matmul disagrees with its plain version at the "
                                     f"t={t} shard of {name} ({K}x{N}): max abs {ea}, rel {er}")
            if launched != (route == "kernel"):
                raise AssertionError(f"t={t} {name}: route {route} but {launched} launches")
            worst = max(worst, ea)
            call = (lambda: k1.int8_matmul(h, q, s, transpose=transpose))
            rows[name] = {
                "K": K, "N": N, "calls_per_step": n, "route": route, "max_abs_err": ea,
                "ms": round(cold_median_ms(call, flush), 4),
                "plain_ms": round(cold_median_ms(
                    lambda: k1.int8_matmul_reference(h, q, s, transpose=transpose), flush), 4),
                "device_ms": round(sum(kernel_device_ms(call, flush).values()), 4),
                "bound_ms": round(bound_ms(4, K, N, bps)[0], 4)}
            del q, s, h
        step = [nm for nm in SHAPES_8B]
        out[f"t{t}"] = {
            "shapes": rows,
            "k1_ms_per_step": round(sum(rows[nm]["ms"] * rows[nm]["calls_per_step"]
                                        for nm in step), 4),
            "k1_device_ms_per_step": round(sum(rows[nm]["device_ms"] * rows[nm]["calls_per_step"]
                                               for nm in step), 4),
            "k1_bound_ms_per_step": round(sum(rows[nm]["bound_ms"] * rows[nm]["calls_per_step"]
                                              for nm in step), 4),
            "int8_bytes_bound_ms_per_step": round(sum(
                rows[nm]["K"] * rows[nm]["N"] * rows[nm]["calls_per_step"] for nm in step)
                / bps * 1e3, 4),
            "dequant_routes": sorted(nm for nm, r in rows.items() if r["route"] != "kernel")}
    del flush
    return {"worlds": out, "max_abs_err": worst,
            "tolerance": "|err| <= 2^-7 |ref| + 1e-3 rms(ref) (bf16), the kernel phase's"}


def profile_counts(prof: dict) -> list:
    """Each component's (name, prefill FLOPs, prefill bytes, decode FLOPs,
    decode bytes) of a layer profile."""
    return [[c["name"], c["prefill"]["flops"], c["prefill"]["bytes"], c["decode"]["flops"],
             c["decode"]["bytes"]] for c in prof["components"]]


def group_profile(k1, cell) -> dict:
    """``POST /v1/profile {"layers": true}`` on a ``chips=1`` llama3-8b cell
    (its rank group's path: every rank runs each component with its
    collectives, on the engine's thread), at serve_tune's shapes. Gates: 34
    components and no error, persisted under ``llama3-8b|gpu|1``; each
    component's FLOPs and bytes those of serve_tune's one-device profile
    (``TUNE_PROFILE``), or of ``layer_cost`` when serve_tune did not run;
    K1 launched (its counter zeroed just before: the eager run and the
    capture of each int8 decode component; replays do not count)."""
    from kukeon_tpu_torch.obs.profile import component_names, layer_cost
    from kukeon_tpu_torch.runtime.serving_cell import serve
    from kukeon_tpu_torch.serving import tuning

    eng = cell.engine
    shape = TUNE_PROFILE.get("shape", (128, eng.num_slots))
    eng.start()
    server = serve(cell)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        k1.int8_matmul.launches = k1.int8_matmul.launches_t = 0
        t0 = time.monotonic()
        prof = post(base + "/v1/profile", {"layers": True, "prefillLen": shape[0],
                                           "decodeBatch": shape[1]})
        seconds = time.monotonic() - t0
        launched = k1.int8_matmul.launches
    finally:
        server.shutdown()
        server.server_close()
        eng.stop()
    key = tuning.profile_key("llama3-8b", "gpu", 1)
    stored = tuning.load_layer_profile("llama3-8b", "gpu", 1)
    if TUNE_PROFILE:
        want, against = TUNE_PROFILE["counts"], "serve_tune"
    else:
        cfg, (S, B) = cell.cfg, shape
        want = []
        for name in component_names(cfg.num_layers):
            kind = name if name in ("embed", "head") else "layer"
            want.append([name, *layer_cost(cfg, kind, 1, S, int8_weights=True),
                         *layer_cost(cfg, kind, B, 1, int8_weights=True)])
        against = "layer_cost"
    if (prof.get("errors") or len(prof["components"]) != 34 or prof.get("key") != key
            or stored is None or stored["components"] != prof["components"]):
        raise AssertionError(f"serve_tp (b) group profile: errors {prof.get('errors')} "
                             f"({[c for c in prof['components'] if 'error' in c][:3]}), "
                             f"{len(prof['components'])} components, key {prof.get('key')}, "
                             f"stored {stored is not None}")
    if profile_counts(prof) != want:
        raise AssertionError(f"serve_tp (b) group profile: FLOPs or bytes differ from "
                             f"{against}'s")
    if launched <= 0:
        raise AssertionError("serve_tp (b) group profile: its int8 components launched no K1")
    decode_ms = {c["name"]: c["decode"]["wall_s"] * 1e3 for c in prof["components"]}
    layers = [v for n, v in decode_ms.items() if n.startswith("layer")]
    return {"key": key, "components": len(prof["components"]), "errors": prof["errors"],
            "seconds": round(seconds, 3), "counts_equal": against, "k1_launches": launched,
            "prefill_len": prof["prefill_len"], "decode_batch": prof["decode_batch"],
            "decode_ms": {"embed": round(decode_ms["embed"], 4),
                          "layers_sum": round(sum(layers), 4),
                          "layer_median": round(statistics.median(layers), 4),
                          "head": round(decode_ms["head"], 4),
                          "all_sum": round(sum(decode_ms.values()), 4)},
            "prefill_ms_sum": round(sum(c["prefill"]["wall_s"] for c in prof["components"])
                                    * 1e3, 4)}


def tp1_serve(k1, make, label: str, profile: bool = False) -> dict:
    """A ``chips=1`` llama3-8b cell from ``make()`` through serve_model: a
    one-rank NCCL group, serve's greedy tokens bitwise, 225 K1 a step in
    the replays; with ``profile``, then its :func:`group_profile`; then its
    graphs freed (this function holds the only reference) and the group
    shut down. -> serve_tp's (b) report (drawn) or serve_stream's
    (streamed), with the cell's :func:`boot_report` under ``"boot"``."""
    import torch.distributed as dist

    from kukeon_tpu_torch.parallel import launch

    t0 = time.monotonic()
    cell = make()
    construct_s = time.monotonic() - t0
    eng = cell.engine
    group = launch.current()
    mesh_info = {"world": eng.world, "kv_sharded": eng.kv_sharded,
                 "backend": dist.get_backend(), "stats_mesh": cell.stats()["mesh"]}
    if eng.mesh is None or eng.world != 1 or group is None or mesh_info["backend"] != "nccl":
        raise AssertionError(f"ServingCell(chips=1) did not serve over a one-rank NCCL group: "
                             f"{mesh_info}")
    del eng
    b = serve_model(k1, "llama3-8b", max_seq_len=1024, prompt_len=128, new=64, profile_new=32,
                    cell=cell, label=label)
    report = {"construct_s": round(construct_s, 3),
              **boot_report(cell, t0, construct_s + b["boot_s"])}
    prof = group_profile(k1, cell) if profile else None
    # The graphs that captured the group's collectives go before the group.
    del cell
    gc.collect()
    torch.cuda.empty_cache()
    launch.shutdown()
    if "llama3-8b" in SERVED_TOKENS:
        if SERVED_TOKENS[label] != SERVED_TOKENS["llama3-8b"]:
            raise AssertionError(f"{label}: ServingCell(chips=1) gave other tokens than serve's")
        b["tokens_equal_serve"] = True
    # The collectives' own kernels among the profile's top device rows
    # (name: launches), if NCCL launches any for one rank.
    nccl = {row[0]: row[2] for row in b["profile"]["top_device_ms"] if "nccl" in row[0].lower()}
    return {**{k: b[k] for k in ("decode_tok_s", "ttft_ms", "ms_per_decode_step",
                                 "launches", "capture_s", "captures", "boot_s",
                                 "peak_mem_gb")},
            "launches_per_step": b["profile"]["launches_per_step"],
            "nccl_kernels_in_top_rows": nccl, "mesh": mesh_info, "label": label,
            "tokens_equal_serve": b.get("tokens_equal_serve", "serve did not run"),
            "boot": report, **({"group_profile": prof} if prof else {})}


def serve_tp(k1, bps: float) -> dict:
    """(a) the shard shapes; (b) llama3-8b int8 through ServingCell(chips=1)
    over a one-rank NCCL group, serve's traffic, its tokens against serve's,
    then its group profile (:func:`group_profile`); (c) the over-grant on one card, in a child process through the cell's
    main and in this process before any byte."""
    from kukeon_tpu_torch.runtime.serving_cell import ServingCell

    # (c) the runner's way (the cell's main, --chips 2) starts first: it
    # exits before it touches the card, while (a) times kernels on it.
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "kukeon_tpu_torch.runtime.serving_cell", "--model", "llama3-8b",
         "--dtype", "int8", "--chips", "2", "--port", "0"],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        out = {"a_shards": serve_tp_kernels(k1, bps)}
        _, stderr = proc.communicate(timeout=300)
    finally:
        proc.kill()
    child_s = time.monotonic() - t0
    want = "--chips 2: serving mesh wants 2 GPUs but only 1 visible"
    if proc.returncode == 0 or want not in stderr:
        raise AssertionError(f"--chips 2 on one card: exit {proc.returncode}, "
                             f"stderr {stderr[-2000:]}")
    out["b_serve"] = tp1_serve(k1, lambda: make_cell("llama3-8b", 1024, chips=1),
                               "llama3-8b tp1", profile=True)
    # (c), then in-process.
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    try:
        ServingCell("llama3-8b", dtype="int8", device="cuda", chips=2)
        raise AssertionError("ServingCell(chips=2) on one card did not exit")
    except SystemExit as e:
        message = str(e)
    if want not in message or torch.cuda.memory_allocated() != before:
        raise AssertionError(f"over-grant: {message!r}, allocated {before} -> "
                             f"{torch.cuda.memory_allocated()}")
    out["c_overgrant"] = {"exit_code": proc.returncode, "child_s": round(child_s, 3),
                          "message": message, "bytes_allocated": 0}
    return out


# serve_tp_cells: the expert kernel's rows at each rank (C), and the
# Mixtral-8x7B vocabulary.
TP_CELL_ROWS = (1, 4, 16, 64)
MIXTRAL_VOCAB = 32000


def tp_cell_shapes(t: int) -> tuple[dict, dict]:
    """(K1 shapes, K2 shapes) of one Mixtral-8x7B rank at tensor
    parallelism t, as parallel/sharding.py cuts them: the trunk as
    tp_shard_shapes cuts llama3-8b's (wq N 4096/t, wk and wv N 1024/t, wo
    K 4096/t), the untied head on its vocabulary columns padded to the
    kernel's 128-wide tiles (32000/t: 16000, 8000 -> 8064, 4000 -> 4096),
    and every expert's w_gate/w_up on their columns (N 14336/t) and
    w_down on its rows (K 14336/t). Each (K, N, calls a step)."""
    from kukeon_tpu_torch.parallel.sharding import VOCAB_TILE

    k1 = {}
    for name, (K, N, n) in SHAPES_MIXTRAL.items():
        if name == "lm_head":
            cols = -(-MIXTRAL_VOCAB // t)
            k1[name] = (K, cols + -cols % VOCAB_TILE, n)
        else:
            k1[name] = (K // t, N, n) if name == "wo" else (K, N // t, n)
    k2 = {name: ((K // t, N, n) if name == "w_down" else (K, N // t, n))
          for name, (K, N, n) in SHAPES_MOE.items()}
    return k1, k2


def check_expert_shard(k1, g: torch.Generator, K: int, N: int, counts: list) -> dict:
    """K2 at one rank's expert shape: every C of TP_CELL_ROWS with every
    row filled, then C = MOE_TOKENS with a routed decode step's rows, whose
    empty slots must come out +0 (bits 0). -> the route, the worst error,
    the weights and the routed rows (for the timings)."""
    q = torch.randint(-127, 128, (MOE_E, K, N), generator=g, device="cuda", dtype=torch.int8)
    s = torch.rand((MOE_E, N), generator=g, device="cuda") * 0.02 + 1e-3
    route = k1._route("cuda", MOE_TOKENS, K, N)
    worst = 0.0
    for C in TP_CELL_ROWS:
        x = torch.randn((MOE_E, C, K), generator=g, device="cuda").to(torch.bfloat16)
        before = k1.int8_matmul_expert.launches
        out = k1.int8_matmul_expert(x, q, s)
        launched = k1.int8_matmul_expert.launches - before
        ref = k1.int8_matmul_expert_reference(x, q, s)
        torch.cuda.synchronize()
        ok, ea, er = within_tol(out, ref)
        if not ok or not torch.isfinite(out).all() or launched != 1:
            raise AssertionError(f"int8_matmul_expert at the shard K={K} N={N} C={C}: "
                                 f"max abs {ea}, rel {er}, {launched} launches")
        worst = max(worst, ea)
    x = torch.zeros((MOE_E, MOE_TOKENS, K), device="cuda", dtype=torch.bfloat16)
    for e, n in enumerate(counts):
        x[e, :n] = torch.randn((n, K), generator=g, device="cuda").to(torch.bfloat16)
    out = k1.int8_matmul_expert(x, q, s)
    ref = k1.int8_matmul_expert_reference(x, q, s)
    torch.cuda.synchronize()
    ok, ea, er = within_tol(out, ref)
    if not ok or not torch.isfinite(out).all():
        raise AssertionError(f"int8_matmul_expert at the shard K={K} N={N}, routed rows "
                             f"{counts}: max abs {ea}, rel {er}")
    for e, n in enumerate(counts):
        if not (torch.all(out[e, n:].view(torch.int16) == 0)
                and torch.all(ref[e, n:].view(torch.int16) == 0)):
            raise AssertionError(f"int8_matmul_expert at the shard K={K} N={N}: the empty "
                                 f"rows of expert {e} are not +0 (routed rows {counts})")
    return {"route": route, "max_abs_err": max(worst, ea), "q": q, "s": s, "routed": x}


def serve_tp_cells_kernels(k1, bps: float) -> dict:
    """(a): K2 at every rank's expert shapes and K1 at every rank's trunk
    and head shapes of Mixtral-8x7B for t in TP_WORLDS, against the plain
    versions; cold-L2 ms beside the bound (C = MOE_TOKENS: filled, and the
    routed decode step's rows), and one rank's K2 and K1 sums for a decode
    step."""
    g = torch.Generator(device="cuda").manual_seed(20)
    counts = decode_routing(g)
    empty = sum(1 for n in counts if n == 0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    worlds, worst = {}, 0.0
    for t in TP_WORLDS:
        k1_shapes, k2_shapes = tp_cell_shapes(t)
        k2_rows, k1_rows = {}, {}
        for name, (K, N, n) in k2_shapes.items():
            if name == "w_up":              # w_gate's shape
                continue
            c = check_expert_shard(k1, g, K, N, counts)
            q, s, routed = c["q"], c["s"], c["routed"]
            x = torch.randn((MOE_E, MOE_TOKENS, K), generator=g, device="cuda").to(
                torch.bfloat16)
            k2_rows[name] = {
                "K": K, "N": N, "calls_per_step": n, "route": c["route"],
                "max_abs_err": c["max_abs_err"], "k_slice": k1.k_slice_expert(
                    MOE_TOKENS, K, N, MOE_E),
                "ms": round(cold_median_ms(lambda: k1.int8_matmul_expert(x, q, s), flush), 4),
                "plain_ms": round(cold_median_ms(
                    lambda: k1.int8_matmul_expert_reference(x, q, s), flush), 4),
                "bound_ms": round(bound_ms(MOE_TOKENS, K, N, bps, MOE_E)[0], 4),
                "routed_ms": round(cold_median_ms(
                    lambda: k1.int8_matmul_expert(routed, q, s), flush), 4),
                "routed_bound_ms": round(bound_ms(MOE_TOKENS, K, N, bps,
                                                  MOE_E - empty)[0], 4)}
            worst = max(worst, c["max_abs_err"])
            del q, s, routed, x
        k2_rows["w_up"] = k2_rows["w_gate"]
        for name, (K, N, n) in k1_shapes.items():
            if name == "wv":                # wk's shape
                continue
            q = torch.randint(-127, 128, (K, N), generator=g, device="cuda", dtype=torch.int8)
            s = torch.rand(N, generator=g, device="cuda") * 0.02 + 1e-3
            h = torch.randn((MOE_TOKENS, K), generator=g, device="cuda").to(torch.bfloat16)
            before = k1.int8_matmul.launches
            got = k1.int8_matmul(h, q, s)
            launched = k1.int8_matmul.launches - before
            ref = k1.int8_matmul_reference(h, q, s)
            torch.cuda.synchronize()
            ok, ea, er = within_tol(got, ref)
            route = k1._route("cuda", MOE_TOKENS, K, N)
            if not ok or not torch.isfinite(got).all() or launched != (route == "kernel"):
                raise AssertionError(f"int8_matmul at the t={t} shard of mixtral {name} "
                                     f"({K}x{N}): max abs {ea}, rel {er}, route {route}, "
                                     f"{launched} launches")
            worst = max(worst, ea)
            k1_rows[name] = {
                "K": K, "N": N, "calls_per_step": n, "route": route, "max_abs_err": ea,
                "ms": round(cold_median_ms(lambda: k1.int8_matmul(h, q, s), flush), 4),
                "plain_ms": round(cold_median_ms(
                    lambda: k1.int8_matmul_reference(h, q, s), flush), 4),
                "bound_ms": round(bound_ms(MOE_TOKENS, K, N, bps)[0], 4)}
            del q, s, h
        k1_rows["wv"] = k1_rows["wk"]

        def per_step(rows, key):
            return round(sum(r[key] * r["calls_per_step"] for r in rows.values()), 4)

        worlds[f"t{t}"] = {
            "k2": k2_rows, "k1": k1_rows,
            "k2_ms_per_step": per_step(k2_rows, "ms"),
            "k2_bound_ms_per_step": per_step(k2_rows, "bound_ms"),
            "k2_routed_ms_per_step": per_step(k2_rows, "routed_ms"),
            "k2_routed_bound_ms_per_step": per_step(k2_rows, "routed_bound_ms"),
            "k1_ms_per_step": per_step(k1_rows, "ms"),
            "k1_bound_ms_per_step": per_step(k1_rows, "bound_ms"),
            "dequant_routes": sorted(nm for nm, r in {**k1_rows, **k2_rows}.items()
                                     if r["route"] != "kernel")}
    del flush
    return {"worlds": worlds, "max_abs_err": worst, "routing_tokens_per_expert": counts,
            "empty_experts": empty,
            "tolerance": "|err| <= 2^-7 |ref| + 1e-3 rms(ref) (bf16); empty rows exactly +0"}


def serve_tp_cells(k1, bps: float) -> dict:
    """(a) the Mixtral shard shapes of K1 and K2; (b) mixtral-8x7b int8
    through ServingCell(chips=1) over a one-rank NCCL group, serve_moe's
    traffic, its tokens against serve_moe's; (c) bge-base through
    EmbeddingCell(chips=1), serve_embed's bursts, its vectors against
    serve_embed's bit for bit; (d) both cells' main with --chips 2 on the
    one card exit 1 before any weight (started beside (a)); (e)
    :func:`mixtral_expert_readers`."""
    import torch.distributed as dist

    from kukeon_tpu_torch.parallel import launch
    from kukeon_tpu_torch.runtime.serving_cell import EmbeddingCell

    # (d) the runner's way, --chips 2 on one card, for both cells at once,
    # started first: they exit before they touch the card, while (a)
    # times kernels on it.
    want_msg = "--chips 2: serving mesh wants 2 GPUs but only 1 visible"
    t_d = time.monotonic()
    procs = {model: subprocess.Popen(
        [sys.executable, "-m", "kukeon_tpu_torch.runtime.serving_cell", "--model", model,
         *extra, "--chips", "2", "--port", "0"],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for model, extra in (("mixtral-8x7b", ["--dtype", "int8"]), ("bge-base", []))}
    children = {}
    try:
        out = {"a_shards": serve_tp_cells_kernels(k1, bps)}
        for model, proc in procs.items():
            _, stderr = proc.communicate(timeout=300)
            if proc.returncode != 1 or want_msg not in stderr:
                raise AssertionError(f"{model} --chips 2 on one card: exit {proc.returncode}, "
                                     f"stderr {stderr[-2000:]}")
            children[model] = {"exit_code": proc.returncode,
                               "child_s": round(time.monotonic() - t_d, 3)}
    finally:
        for proc in procs.values():
            proc.kill()
    t0 = time.monotonic()
    cell = make_cell("mixtral-8x7b", 1024, chips=1)
    construct_s = time.monotonic() - t0
    eng = cell.engine
    mesh_info = {"world": eng.world, "kv_sharded": eng.kv_sharded,
                 "backend": dist.get_backend(), "stats_mesh": cell.stats()["mesh"]}
    if eng.mesh is None or eng.world != 1 or launch.current() is None \
            or mesh_info["backend"] != "nccl":
        raise AssertionError(f"mixtral ServingCell(chips=1) did not serve over a one-rank "
                             f"NCCL group: {mesh_info}")
    del eng
    b = serve_model(k1, "mixtral-8x7b", max_seq_len=1024, prompt_len=128, new=32,
                    profile_new=16, cell=cell, label="mixtral-8x7b tp1")
    del cell
    gc.collect()
    torch.cuda.empty_cache()
    if "mixtral-8x7b" in SERVED_TOKENS:
        if SERVED_TOKENS["mixtral-8x7b tp1"] != SERVED_TOKENS["mixtral-8x7b"]:
            raise AssertionError("mixtral ServingCell(chips=1) gave other tokens than "
                                 "serve_moe's cell")
        b["tokens_equal_serve_moe"] = True
    out["b_serve"] = {**{k: b[k] for k in ("decode_tok_s", "ttft_ms", "ms_per_decode_step",
                                             "launches", "capture_s", "captures", "boot_s",
                                             "peak_mem_gb")},
                      "construct_s": round(construct_s, 3),
                      "launches_per_step": b["profile"]["launches_per_step"],
                      "device_idle_share": b["profile"]["device_idle_share"],
                      "top_device_ms": b["profile"]["top_device_ms"][:12],
                      "mesh": mesh_info,
                      "tokens_equal_serve_moe": b.get("tokens_equal_serve_moe",
                                                      "serve_moe did not run")}
    # (c) the embedding cell over the same one-rank group.
    t0 = time.monotonic()
    ecell = EmbeddingCell("bge-base", batch_size=EMBED_GRID, device="cuda", chips=1)
    boot_s = time.monotonic() - t0
    if ecell.engine.mesh is None or ecell.stats()["mesh"] != {"chips": 1, "shape": {}}:
        raise AssertionError(f"EmbeddingCell(chips=1) is not on a rank group: "
                             f"{ecell.stats().get('mesh')}")
    bursts = EMBEDDED.get("bursts")
    if bursts is None:        # serve_embed did not run: its bursts, vectors from one device
        rng = np.random.default_rng(13)
        seqs = [rng.integers(1, ecell.cfg.vocab_size, n).tolist() for n in embed_lengths(rng)]
        bursts = [seqs[i:i + EMBED_BURST] for i in range(0, len(seqs), EMBED_BURST)]
        one = EmbeddingCell("bge-base", batch_size=EMBED_GRID, device="cuda")
        want = np.array([v for bt in bursts for v in one.embed({"inputTokens": bt})[
            "embeddings"]], np.float32)
        del one
    else:
        want = EMBEDDED["vecs"]
    t0 = time.monotonic()
    got = np.array([v for bt in bursts for v in ecell.embed({"inputTokens": bt})["embeddings"]],
                   np.float32)
    embed_s = time.monotonic() - t0
    if got.shape != want.shape or not np.array_equal(got.view(np.int32), want.view(np.int32)):
        diff = float(np.abs(got - want).max()) if got.shape == want.shape else None
        raise AssertionError(f"EmbeddingCell(chips=1) vectors differ from serve_embed's "
                             f"(max abs {diff})")
    out["c_embed"] = {"bitwise_equal": True, "sequences": int(got.shape[0]),
                      "boot_s": round(boot_s, 3), "embed_s": round(embed_s, 3),
                      "against": "serve_embed" if "bursts" in EMBEDDED else "one device, here"}
    del ecell
    gc.collect()
    torch.cuda.empty_cache()
    launch.shutdown()
    out["d_overgrant"] = children
    out["e_expert_reader"] = mixtral_expert_readers()
    return out


# serve_tp_cells (e): Mixtral-8x7B at full width, cut to this many layers.
MIXTRAL_CUT_LAYERS = 1


def write_mixtral_hf(path: str, cfg, seed: int, device: str = "cuda") -> dict:
    """An HF Mixtral directory at ``cfg``'s shapes, bf16, drawn on the card
    from ``seed`` (normal times ``fan_in ** -0.5``; norms ones) and written
    with the port's safetensors writer in shards of at most 2 GiB, with its
    index and config.json. -> the one-device tree in full precision, on the
    card (what ``hf_convert.load_moe_params`` reads back: the same bf16
    values, the router in f32)."""
    from kukeon_tpu_torch.models import checkpoints

    os.makedirs(path, exist_ok=True)
    g = torch.Generator(device=device).manual_seed(seed)
    L, E, H, I = cfg.num_layers, cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
    V, bf = cfg.vocab_size, torch.bfloat16

    def draw(shape, fan_in):
        if fan_in is None:
            return torch.ones(shape, dtype=bf, device=device)
        w = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
        return w.mul_(fan_in ** -0.5).to(bf)

    tree = {"embed": None, "layers": {k: [] for k in (
        "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "router", "w_gate", "w_up",
        "w_down")}}
    weight_map, shard, shard_bytes, shards = {}, {}, 0, []

    def put(name, t):
        nonlocal shard, shard_bytes
        nbytes = t.numel() * t.element_size()
        if shard and shard_bytes + nbytes > 2 << 30:
            flush()
        shard[name] = t
        shard_bytes += nbytes

    def flush():
        nonlocal shard, shard_bytes
        fname = f"model-{len(shards) + 1:05d}.safetensors"
        checkpoints.save_safetensors(shard, os.path.join(path, fname))
        weight_map.update({n: fname for n in shard})
        shards.append(fname)
        shard, shard_bytes = {}, 0

    emb = draw((V, H), H)
    put("model.embed_tokens.weight", emb)
    tree["embed"] = emb
    lw = tree["layers"]
    for i in range(L):
        p = f"model.layers.{i}."
        for key, name, shape, fan_in in (
                ("attn_norm", "input_layernorm", (H,), None),
                ("wq", "self_attn.q_proj", (cfg.q_dim, H), H),
                ("wk", "self_attn.k_proj", (cfg.kv_dim, H), H),
                ("wv", "self_attn.v_proj", (cfg.kv_dim, H), H),
                ("wo", "self_attn.o_proj", (H, cfg.q_dim), cfg.q_dim),
                ("mlp_norm", "post_attention_layernorm", (H,), None),
                ("router", "block_sparse_moe.gate", (E, H), H)):
            w = draw(shape, fan_in)
            put(p + name + ".weight", w)
            lw[key].append(w if fan_in is None else w.T)
        for key, w_name, shape, fan_in in (("w_gate", "w1", (I, H), H), ("w_up", "w3", (I, H), H),
                                           ("w_down", "w2", (H, I), I)):
            mats = []
            for e in range(E):
                w = draw(shape, fan_in)
                put(f"{p}block_sparse_moe.experts.{e}.{w_name}.weight", w)
                mats.append(w.T)
            lw[key].append(torch.stack(mats))
    final = draw((H,), None)
    put("model.norm.weight", final)
    head = draw((V, H), H)
    put("lm_head.weight", head)
    flush()
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"weight_map": weight_map}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"architectures": ["MixtralForCausalLM"], "vocab_size": V, "hidden_size": H,
                   "intermediate_size": I, "num_hidden_layers": L,
                   "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
                   "head_dim": cfg.head_dim, "num_local_experts": E,
                   "num_experts_per_tok": cfg.experts_per_token, "rope_theta": cfg.rope_theta,
                   "rms_norm_eps": cfg.rms_norm_eps,
                   "max_position_embeddings": cfg.max_seq_len, "tie_word_embeddings": False,
                   "torch_dtype": "bfloat16"}, f)
    tree["layers"] = {k: torch.stack(v).contiguous() for k, v in lw.items()}
    tree["layers"]["router"] = tree["layers"]["router"].float()
    tree["final_norm"] = final
    tree["lm_head"] = head.T.contiguous()
    return tree


def mixtral_expert_readers(cfg=None) -> dict:
    """serve_tp_cells (e): an HF Mixtral-8x7B directory at full width, cut
    to :data:`MIXTRAL_CUT_LAYERS` of 32 layers, read by the ranks of t 8
    at once, each in a process of its own (``hf_convert.moe_rank_leaves``,
    int8: every expert matrix's rows or columns read in staging blocks and
    quantized on the card; :func:`rank_readers`): each rank's leaves sum
    as the blocks of the one-device tree quantized on the card
    (``moe.quantize_params``). Per rank: seconds, its leaves' bytes, the
    most a read declared on the host (``job_peak_bytes``) and its
    process's VmRSS growth. (``cfg``: a rehearsal's.)"""
    from kukeon_tpu_torch.models import moe

    cfg = cfg or dataclasses.replace(moe.mixtral_8x7b(), num_layers=MIXTRAL_CUT_LAYERS)
    root = tempfile.mkdtemp(prefix="kukeon-mixtral-hf-")
    t = 8
    try:
        t0 = time.monotonic()
        full = write_mixtral_hf(root, cfg, seed=11, device=_card())
        write_s = time.monotonic() - t0
        nbytes = dir_bytes(root)
        ref = moe.quantize_params(full)
        del full
        readers = rank_readers({"kind": "moe", "root": root, "cfg": cfg}, ref, cfg, (t,))
        del ref
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "t": t, "checkpoint_bytes": nbytes,
            "write_s": round(write_s, 3), "ranks": readers[f"t{t}"]["ranks"],
            "seconds": readers[f"t{t}"]["seconds"], "dir_removed": not os.path.exists(root)}


def sass_counts(built: dict) -> dict:
    """{source: {kernel: {"HGMMA": n, "HMMA": n}}} from cuobjdump's SASS of
    each built library: the tensor-core instructions each kernel holds."""
    from kukeon_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    out = {}
    for src, (path, _log, _secs) in built.items():
        sass = subprocess.run([tool, "--dump-sass", str(path)], capture_output=True, text=True,
                              timeout=300, check=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                counts[fn] = {"HGMMA": 0, "HMMA": 0}
            elif fn is not None:
                for op in ("HGMMA", "HMMA"):
                    if op + "." in line:
                        counts[fn][op] += 1
        out[src] = {k: v for k, v in counts.items() if v["HGMMA"] or v["HMMA"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                         + " (card always runs); a subset prints no result line")
    phases = ap.parse_args(argv).phases.split(",")
    if not set(phases) <= set(PHASES):
        ap.error(f"unknown phases {sorted(set(phases) - set(PHASES))}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 2
    # The tuning and layer profiles of this run live in a temporary
    # directory of its own: a profile left in ~/.kuke can never change a
    # phase's levers, and serve_tune's winner is removed after it.
    profiles = tempfile.mkdtemp(prefix="kukeon-profiles-")
    os.environ["KUKEON_TUNE_PATH"] = os.path.join(profiles, "serving_tune.json")
    os.environ["KUKEON_LAYER_PROFILE_PATH"] = os.path.join(profiles, "layer_profile.json")
    try:
        return run_phases(phases)
    finally:
        shutil.rmtree(profiles, ignore_errors=True)


def run_phases(phases: list) -> int:
    from kukeon_tpu_torch.ops import _build
    from kukeon_tpu_torch.ops import flash_attention as fa
    from kukeon_tpu_torch.ops import int8_matmul as k1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    bps = hbm_bps(name)

    with phase("card", {}) as p:
        t0 = time.monotonic()
        with contextlib.ExitStack() as stack:
            # The checkpoint reader's host library builds beside the kernels.
            pool = stack.enter_context(concurrent.futures.ThreadPoolExecutor(1))
            host = pool.submit(_build.build, _build.ZSTD_DECODE)
            built = _build.build_all()
            host_lib = host.result()
        p.update(nvidia_smi=smi, device=name, torch=torch.__version__,
                 cuda=torch.version.cuda, python=sys.version.split()[0],
                 hbm_bytes_per_s=bps, build_wall_s=round(time.monotonic() - t0, 2),
                 build_s={src: round(secs, 2) for src, (_p, _l, secs) in built.items()},
                 host_build_s={_build.ZSTD_DECODE: round(host_lib[2], 2)},
                 tmp_free_gb=round(shutil.disk_usage(tempfile.gettempdir()).free / 1e9, 1),
                 ptxas={src: [ln.strip() for ln in log.splitlines()
                              if "Compiling entry" in ln or "registers" in ln or "spill" in ln
                              or "warning" in ln]
                        for src, (_p, log, _s) in built.items()},
                 sass_tensor_core_ops=sass_counts(built))
        flash_hgmma = sum(v["HGMMA"] for k, v in p["sass_tensor_core_ops"][
            _build.FLASH_ATTENTION].items() if "flash_fwd_bf16" in k)
        if flash_hgmma == 0:
            raise AssertionError("the bf16 flash kernels hold no HGMMA instruction")
        k1_hmma = sum(v["HMMA"] for k, v in p["sass_tensor_core_ops"][
            _build.INT8_MATMUL].items() if "int8_mm_bf16" in k)
        if k1_hmma == 0:
            raise AssertionError("int8_mm_bf16_kernel holds no HMMA instruction")
        k1t_hmma = sum(v["HMMA"] for k, v in p["sass_tensor_core_ops"][
            _build.INT8_MATMUL].items() if "int8_mm_t_bf16" in k)
        if k1t_hmma == 0:
            raise AssertionError("int8_mm_t_bf16_kernel holds no HMMA instruction")

    res = {}

    def run(phase_name, fn):
        if phase_name in phases:
            with phase(phase_name, {}) as p:
                p.update(fn())
            res[phase_name] = p
        gc.collect()
        torch.cuda.empty_cache()

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    run("kernel", lambda: {**phase_kernel(k1, bps, flush), **k1_one_launch(k1)})
    run("flash", lambda: {**phase_flash(fa, bps, flush), "long_s": flash_long(fa)})
    run("moe_kernel", lambda: phase_moe_kernel(k1, bps, flush))
    del flush
    if {"serve_stream", "serve_ckpt", "serve_tp_cells"} & set(phases):
        # The rank readers' fork server imports while the model phase runs
        # (after the kernels' timings, which a busy host would disturb).
        fork_server()
    run("model", lambda: phase_model(k1))
    kept = {}
    run("serve", lambda: {
        **serve_model(k1, "llama3-8b", max_seq_len=1024, prompt_len=128, new=64,
                      profile_new=32, stream_stop=True,
                      keep=kept if {"serve_obs", "serve_stream", "serve_tune"} & set(phases)
                      else None),
        "bound_ms_per_decode_step": round(sum(
            bound_ms(4, K, N, bps)[0] * n for K, N, n in SHAPES_8B.values()), 4)})
    run("serve_obs", lambda: serve_obs(kept["llama3-8b"], bps))
    run("serve_stream", lambda: serve_stream(k1, kept["llama3-8b"]))
    run("serve_tune", lambda: serve_tune(kept["llama3-8b"]))
    kept.clear()
    run("serve_tp", lambda: serve_tp(k1, bps))
    run("serve_tied", lambda: serve_model(k1, "llama3-1b", max_seq_len=CKPT_SEQ,
                                          prompt_len=CKPT_PROMPT, new=CKPT_NEW))
    run("serve_ckpt", lambda: serve_ckpt(k1))
    run("serve_orbax", lambda: serve_orbax(k1))
    run("serve_tiny", lambda: {m: serve_model(k1, m, max_seq_len=256, prompt_len=32, new=16)
                               for m in ("tiny", "mixtral-tiny")})
    # One Mixtral-8x7B draw (46.7 GB of int8) serves its four phases, and
    # one llama3-8b draw both graph phases.
    cell = {}
    if {"moe_model", "graph_decode", "graph_prefill", "serve_moe"} & set(phases):
        t0 = time.monotonic()
        cell["moe"] = make_cell("mixtral-8x7b", 1024)
        cell["draw_s"] = round(time.monotonic() - t0, 3)
    run("moe_model", lambda: {"draw_s": cell["draw_s"],
                              **phase_moe_model(k1, cell["moe"].engine.params)})

    def dense():
        if "dense" not in cell:
            cell["dense"] = make_cell("llama3-8b", 1024)
        return cell["dense"]

    def graph_phase(check):
        out = {"llama3-8b": check(dense())}
        out["mixtral-8x7b"] = check(cell["moe"])
        return out

    run("graph_decode", lambda: graph_phase(graph_decode_check))
    run("graph_prefill", lambda: graph_phase(graph_prefill_check))
    run("graph_paged", lambda: {"llama3-8b": graph_paged_check(dense())})
    cell.pop("dense", None)
    gc.collect()
    torch.cuda.empty_cache()

    def serve_moe_phase():
        out = serve_model(k1, "mixtral-8x7b", max_seq_len=1024, prompt_len=128, new=32,
                          profile_new=16, cell=cell["moe"])
        # The same drawn weights behind a paged engine: the same tokens, and
        # the same kernels a step inside its replays.
        twin = twin_cell(cell["moe"])
        paged = serve_model(k1, "mixtral-8x7b", max_seq_len=1024, prompt_len=128, new=32,
                            profile_new=16, cell=twin, label="mixtral-8x7b paged")
        if SERVED_TOKENS["mixtral-8x7b paged"] != SERVED_TOKENS["mixtral-8x7b"]:
            raise AssertionError("mixtral paged layout: greedy tokens differ from the legacy's")
        # Both layouts' 16-step decode program alone, in turns.
        from kukeon_tpu_torch.serving.programs import program_key

        with torch.no_grad():
            turns = [[arm, replay_timing(eng._programs, program_key(16, False, False))]
                     for arm, eng in (("legacy", cell["moe"].engine), ("paged", twin.engine),
                                      ("paged", twin.engine), ("legacy", cell["moe"].engine))]
        # One KV handoff on the same weights: the legacy engine exports the
        # first prompt, the paged engine imports it.
        handoff = engine_handoff(cell["moe"].engine, twin.engine,
                                 SERVED_PROMPTS["mixtral-8x7b"][0],
                                 SERVED_TOKENS["mixtral-8x7b"][0])
        del twin
        out["handoff_legacy_to_paged"] = handoff
        out["paged"] = {k: paged[k] for k in (
            "kv_page_tokens", "kv_pool_pages", "view_bytes", "ttft_ms", "ms_per_decode_step",
            "decode_tok_s", "launches", "pool_bytes", "prefill",
            "captures_after_warmup_in_traffic", "peak_mem_gb")}
        out["paged"]["launches_per_step"] = paged["profile"]["launches_per_step"]
        out["paged"]["replay_16_in_turns"] = [
            [arm, t["event_ms_per_step"], round(t["kernel_device_ms"] / 16, 3)]
            for arm, t in turns]
        out["paged"]["tokens_equal_legacy"] = True
        out["bound_ms_per_decode_step"] = round(
            sum(bound_ms(4, K, N, bps)[0] * n for K, N, n in SHAPES_MIXTRAL.values())
            + sum(bound_ms(4, K, N, bps, MOE_E)[0] * n for K, N, n in SHAPES_MOE.values()), 4)
        return out

    run("serve_moe", serve_moe_phase)
    cell.clear()
    run("serve_prefix", serve_prefix)
    run("serve_paged", lambda: serve_paged(k1))
    run("serve_disagg", lambda: serve_disagg(k1))

    def train():
        out = phase_train(fa)
        if "flash" in res:
            out["flash_share_of_step"] = round(res["flash"]["timing"]["ms"]
                                               * out["flash_launches_per_step"]
                                               / out["step_ms_median_3_8"], 4)
        return out

    run("serve_embed", serve_embed)
    run("serve_tp_cells", lambda: serve_tp_cells(k1, bps))
    run("train", train)
    run("train_tp", lambda: phase_train_tp(fa, bps, res.get("train")))

    def train_moe():
        out = phase_train_moe(fa)
        if "flash" in res:
            out["flash_share_of_step"] = round(
                res["flash"]["timing_mixtral_train"]["ms"] * out["flash_launches_per_step"][0]
                / out["step_ms_median_3_6"], 4)
        return out

    run("train_moe", train_moe)
    run("train_moe_tp", lambda: phase_train_moe_tp(fa, bps, res.get("train_moe")))
    run("train_sp_pp", lambda: phase_train_sp_pp(fa, bps, res.get("train")))
    run("train_moe_sp", lambda: phase_train_moe_sp(fa, bps))
    run("gpu_grants", phase_gpu_grants)
    if set(phases) != set(PHASES):
        print("chip_smoke: ran a subset of the phases; no result line", file=sys.stderr)
        return 0

    kern, flash, moe_kern = res["kernel"], res["flash"], res["moe_kernel"]
    serve8, serve1, serve_moe, train = (res["serve"], res["serve_tied"], res["serve_moe"],
                                        res["train"])
    train_moe, embed, ckpt = res["train_moe"], res["serve_embed"], res["serve_ckpt"]
    ttp, tmtp, tsp = res["train_tp"], res["train_moe_tp"], res["train_sp_pp"]
    stream, tune, orbax = res["serve_stream"], res["serve_tune"], res["serve_orbax"]
    tp, tpc = res["serve_tp"], res["serve_tp_cells"]
    ft, fm = flash["timing"], flash["timing_mixtral_train"]
    for label, run_, key in (("llama3-8b", serve8, "k1"), ("llama3-1b", serve1, "k1t"),
                             ("llama3-1b ckpt", ckpt, "k1"), ("llama3-1b ckpt", ckpt, "k1t"),
                             ("llama3-8b stream", stream, "k1"),
                             ("llama3-1b orbax", orbax, "k1"), ("llama3-1b orbax", orbax, "k1t"),
                             ("mixtral-8x7b", serve_moe, "k1"), ("mixtral-8x7b", serve_moe, "k2"),
                             ("mixtral-8x7b tp1", tpc["b_serve"], "k1"),
                             ("mixtral-8x7b tp1", tpc["b_serve"], "k2")):
        if run_["launches"][key] <= 0:
            raise AssertionError(f"{label} serving launched no {key} kernel")
    gd, gp, sp = res["graph_decode"], res["graph_prefill"], res["serve_prefix"]
    gpg, spg, sdg = res["graph_paged"]["llama3-8b"], res["serve_paged"], res["serve_disagg"]

    # K1: one llama3-8b decode step's worth of calls at B = 4 (225 launches).
    fields = ("ms", "plain_ms", "library_ms", "bound_ms")
    t = kern["timings"]
    per_step = {f: round(sum(t[nm][f] * SHAPES_8B[nm][2] for nm in SHAPES_8B), 4)
                for f in fields}
    tied = t["tied_head_1b"]
    # K2: one mixtral-8x7b decode step's worth at C = 4 (96 launches).
    tm = moe_kern["timings"]
    per_step_moe = {f: round(sum(tm[nm][f] * SHAPES_MOE[nm][2] for nm in SHAPES_MOE), 4)
                    for f in fields}
    kernels = [
        {"name": "int8_matmul", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES,
         "launches": (serve8["launches"]["k1"] + ckpt["launches"]["k1"]
                      + stream["launches"]["k1"] + orbax["launches"]["k1"]
                      + tp["b_serve"]["launches"]["k1"] + tpc["b_serve"]["launches"]["k1"]),
         "launches_serve": serve8["launches"]["k1"], "launches_ckpt": ckpt["launches"]["k1"],
         "launches_serve_tp": tp["b_serve"]["launches"]["k1"],
         "launches_serve_tp_cells": tpc["b_serve"]["launches"]["k1"],
         "launches_stream": stream["launches"]["k1"], "launches_orbax": orbax["launches"]["k1"],
         "launches_paged": spg["layout_check"]["launches"]["k1"],
         "launches_disagg": sdg["parity"]["launches"]["k1"],
         "max_abs_err": kern["max_abs_err"], **per_step, "bound_by": "bytes",
         "library_ms_call": kern["library_call"],
         "device_ms": round(sum(t[nm]["device_ms"] * SHAPES_8B[nm][2] for nm in SHAPES_8B), 4),
         "device_ms_per_call": {nm: round(t[nm]["device_ms"], 4) for nm in SHAPES_8B},
         "kernels_per_call": sum(kern["kernels_per_call"].values()),
         "repeat_bit_identical": kern["repeat_bit_identical"], "design": K1_DESIGN,
         "unit": "one llama3-8b decode step at B=4 (225 launches); device_ms_per_call: "
                 "one call of each projection at B=4"},
        {"name": "int8_matmul_transposed", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1T_REPLACES,
         "launches": (serve1["launches"]["k1t"] + ckpt["launches"]["k1t"]
                      + orbax["launches"]["k1t"]),
         "launches_serve_tied": serve1["launches"]["k1t"], "launches_ckpt": ckpt["launches"]["k1t"],
         "launches_orbax": orbax["launches"]["k1t"],
         "max_abs_err": tied["max_abs_err"], "ms": round(tied["ms"], 4),
         "plain_ms": round(tied["plain_ms"], 4), "bound_ms": round(tied["bound_ms"], 4),
         "bound_by": tied["bound_by"], "library_ms": round(tied["library_ms"], 4),
         "library_ms_call": kern["library_call"], "device_ms": round(tied["device_ms"], 4),
         "device_ms_transposed_b4": kern["transposed_device_ms_b4"],
         "f32_max_abs_err": kern["f32_transposed_max_abs_err"],
         "kernels_per_call": sum(kern["kernels_per_call_t"].values()),
         "repeat_bit_identical": kern["repeat_bit_identical"], "design": K1T_DESIGN,
         "unit": "llama3-1b tied LM head, B=4; device_ms_transposed_b4: one call at each "
                 "further transposed (K x N), B=4"},
        {"name": "flash_attention", "route": "cuda", "source": K3_SOURCE,
         "replaces": K3_REPLACES,
         "launches": (train["flash_launches"] + train_moe["flash_launches"]
                      + ttp["b_mesh"]["flash_launches"] + tmtp["b_mesh"]["flash_launches"]
                      + tsp["b_pipeline"]["flash_launches"]),
         "launches_train": train["flash_launches"],
         "launches_train_moe": train_moe["flash_launches"],
         "launches_train_tp": ttp["b_mesh"]["flash_launches"],
         "launches_train_moe_tp": tmtp["b_mesh"]["flash_launches"],
         "launches_train_sp_pp": tsp["b_pipeline"]["flash_launches"],
         **{f"{name}_shards": {w: {k: v[k] for k in (
             "shape", "ms", "plain_ms", "library_ms", "device_ms", "bound_ms", "bound_by",
             "max_abs_err")} for w, v in r["a_shards"]["worlds"].items()}
            for name, r in (("train_tp", ttp), ("train_moe_tp", tmtp))},
         "train_sp_pp_stages": {w: {k: v[k] for k in (
             "shape", "ms", "plain_ms", "library_ms", "device_ms", "bound_ms", "bound_by",
             "max_abs_err")} for w, v in tsp["a_stage_flash"]["shapes"].items()},
         "max_abs_err": max(c["max_abs_err"] for c in flash["cases"]),
         **{f: round(ft[f], 4) for f in fields},
         "bound_by": ft["bound_by"], "library_ms_call": ft["library_call"],
         "peak_share": round(ft["peak_share"], 4), "device_ms": round(ft["device_ms"], 4),
         "device_peak_share": round(ft["device_peak_share"], 4),
         "mixtral_train": {**{f: round(fm[f], 4) for f in fields},
                           "bound_by": fm["bound_by"], "max_abs_err": fm["max_abs_err"],
                           "device_ms": round(fm["device_ms"], 4),
                           "device_peak_share": round(fm["device_peak_share"], 4)},
         "design": K3_DESIGN,
         "unit": "one call at B=4 S=2048 H=32 KV=8 D=64 bf16 (llama3-1b training), "
                 f"{train['flash_launches_per_step']} launches per train step; mixtral_train: "
                 "one call at B=2 S=2048 H=32 KV=8 D=128, "
                 f"{train_moe['flash_launches_per_step'][0]} launches per MoE train step"},
        {"name": "int8_matmul_expert", "route": "cuda", "source": K1_SOURCE,
         "replaces": K2_REPLACES,
         "launches": serve_moe["launches"]["k2"] + tpc["b_serve"]["launches"]["k2"],
         "launches_serve_moe": serve_moe["launches"]["k2"],
         "launches_serve_tp_cells": tpc["b_serve"]["launches"]["k2"],
         "launches_paged": serve_moe["paged"]["launches"]["k2"],
         "max_abs_err": moe_kern["max_abs_err"], **per_step_moe,
         "bound_by": tm["w_gate"]["bound_by"], "library_ms_call": moe_kern["library_call"],
         "per_call": {nm: {f: round(tm[nm][f], 4) for f in fields}
                      for nm in ("w_gate", "w_down", "w_gate_routed", "w_down_routed")},
         "device_ms_per_call": {nm: round(sum(moe_kern["device_ms_per_call_c4"][nm].values()), 4)
                                for nm in ("w_gate", "w_down")},
         "empty_experts_routed": moe_kern["empty_experts"], "design": K2_DESIGN,
         "unit": "one mixtral-8x7b decode step at C=4 (96 launches of E=8 experts), every "
                 "expert's rows filled; per_call: one launch, filled and with the rows of a "
                 "routed decode step (its bound counts the experts in use)"},
    ]
    # The serve phases' end-to-end numbers again, short, so that the last
    # lines of the output carry every number the run is quoted for.
    e2e_keys = ("decode_tok_s", "ttft_ms", "ms_per_decode_step", "launches", "capture_s",
                "pool_bytes", "prefill")
    emit({"end_to_end": {
        "phase_s": {n: r["wall_s"] for n, r in res.items()},
        "llama3-8b": {**{k: serve8[k] for k in e2e_keys},
                      "bound_ms_per_decode_step": serve8["bound_ms_per_decode_step"],
                      "device_idle_share": serve8["profile"]["device_idle_share"]},
        "llama3-1b": {**{k: serve1[k] for k in e2e_keys},
                      "device_idle_share": serve1["profile"]["device_idle_share"]},
        "mixtral-8x7b": {**{k: serve_moe[k] for k in e2e_keys + ("peak_mem_gb",)},
                         "bound_ms_per_decode_step": serve_moe["bound_ms_per_decode_step"],
                         "device_idle_share": serve_moe["profile"]["device_idle_share"]},
        "graph_decode_bitwise": {m: sorted(v for v in gd[m] if v in ("greedy", "stochastic"))
                                 for m in ("llama3-8b", "mixtral-8x7b")},
        "graph_prefill_bitwise": {m: sorted(k for k, v in gp[m].items()
                                            if isinstance(v, dict) and "bitwise_equal" in v)
                                  for m in ("llama3-8b", "mixtral-8x7b")},
        "serve_prefix_llama3-8b": {k: sp[k] for k in (
            "prefix_cache", "ttft_ms_median_by_turn", "captures_after_warmup",
            "turns_equal_to_control", "first_hit_turn_equal")},
        "serve_stream_stop": serve8["stream_stop"],
        "serve_obs_llama3-8b": {k: res["serve_obs"][k] for k in (
            "scrape_ms_under_traffic", "captured_mid_traffic", "decode_chunk",
            "hbm_bytes_peak", "probe")},
        "graph_paged_bitwise": {kv: {"prefill": sorted(gpg[kv]["prefill"]),
                                     "decode": sorted(k for k in gpg[kv]["decode"]
                                                      if k != "replay_16")}
                                for kv in ("bf16_kv", "int8_kv")},
        "serve_paged_llama3-8b": {
            "layout_check": {k: spg["layout_check"][k] for k in (
                "ms_per_decode_step", "ttft_ms", "view_bytes", "launches")},
            "arms": {arm: {k: v[k] for k in (
                "tok_per_s", "ttft_ms_p50", "ttft_ms_p95", "itl_ms_median",
                "wall_ms_per_decode_step", "replay_event_ms_per_step", "prefix_hits",
                "preemptions",
                "peak_pages_in_use", "decode_pool_bytes", "prefill_pool_bytes", "view_bytes")}
                for arm, v in spg["arms"].items()}},
        "mixtral-8x7b_paged": {k: serve_moe["paged"][k] for k in (
            "ms_per_decode_step", "ttft_ms", "launches_per_step", "view_bytes",
            "replay_16_in_turns")},
        "mixtral-8x7b_handoff": serve_moe["handoff_legacy_to_paged"],
        "serve_disagg_llama3-8b": {
            "parity": {k: sdg["parity"][k] for k in ("tokens_equal_serve", "launches",
                                                     "kv_bytes_per_token", "rounds")},
            "arms": sdg["arms"], "wall_s": sdg["wall_s"]},
        "train_llama3-1b": {k: train[k] for k in (
            "step_ms_median_3_8", "tokens_per_s", "mfu", "peak_mem_gb", "first_loss",
            "last_loss", "flash_launches_per_step", "flash_share_of_step", "save_s",
            "step_dir_bytes")},
        "train_tp_llama3-1b": {
            **{k: ttp["b_mesh"][k] for k in (
                "losses", "losses_equal_train", "step_ms_median_2_3", "peak_mem_gb",
                "flash_launches_per_step", "llama3-8b_rank_state_gb")},
            "train_step_ms_median_3_8": train["step_ms_median_3_8"],
            "a_flash_device_ms": {w: v["device_ms"] for w, v in
                                  ttp["a_shards"]["worlds"].items()},
            "a_flash_bound_ms": {w: v["bound_ms"] for w, v in
                                 ttp["a_shards"]["worlds"].items()},
            "c_message": ttp["c_overgrant"]["message"]},
        "train_moe_mixtral-8x7b_4_layers": {k: train_moe[k] for k in (
            "step_ms_median_3_6", "tokens_per_s", "mfu", "peak_mem_gb", "losses",
            "step1_rel_diff", "flash_launches_per_step")},
        "train_moe_tp_mixtral-8x7b_4_layers": {
            **{k: tmtp["b_mesh"][k] for k in (
                "metrics", "metrics_equal_train_moe", "step_ms", "step_ms_median_2_3",
                "peak_mem_gb", "flash_launches_per_step", "mixtral-8x7b_rank_state_gb")},
            "train_moe_step_ms_median_3_6": train_moe["step_ms_median_3_6"],
            "a_flash_device_ms": {w: v["device_ms"] for w, v in
                                  tmtp["a_shards"]["worlds"].items()},
            "a_flash_bound_ms": {w: v["bound_ms"] for w, v in
                                 tmtp["a_shards"]["worlds"].items()},
            "c_message": tmtp["c_overgrant"]["message"]},
        "train_sp_pp_llama3-1b": {
            "a_ring": {k: tsp["a_ring"][k] for k in (
                "max_abs_err", "rel_rms_err", "ring_block", "ring_block_sdpa",
                "ulysses_local", "ulysses_local_sdpa")},
            "b_pipeline": {k: tsp["b_pipeline"][k] for k in (
                "losses", "loss_rel_diff", "step_ms_median_2_3", "peak_mem_gb",
                "flash_launches_per_step", "llama3-8b_rank_state_gb")},
            "train_step_ms_median_3_8": train["step_ms_median_3_8"],
            "c_messages": {a: v["message"] for a, v in tsp["c_overgrant"].items()}},
        "train_moe_sp_mixtral-8x7b_layer": {
            **{f"capacity_factor_{cf}": {k: res["train_moe_sp"][f"capacity_factor_{cf}"][k]
                                         for k in ("capacity", "dropped_share")}
               for cf in (2.0, 1.0)},
            "b_seq_flash": {"launches": {s: r["launches"] for s, r in
                                         res["train_moe_sp"]["b_seq_flash"]["ranks"].items()},
                            "timing_last_block":
                                res["train_moe_sp"]["b_seq_flash"]["timing_last_block"]}},
        "gpu_grants": {k: res["gpu_grants"][k] for k in (
            "discovered", "grant", "child_device_count", "numberings")},
        "serve_stream_llama3-8b": {
            **{k: stream[k] for k in (
                "tmp_free_gb", "save_s", "checkpoint_bytes", "construct_s", "ready_s",
                "stages_s", "marks_s", "capture_overlap_share_of_load", "load_bytes_counter",
                "leaf_bytes", "tokens_equal_serve", "launches_per_step", "ms_per_decode_step")},
            "b_tp1": {k: stream["b_tp1"][k] for k in (
                "ready_s", "stages_s", "marks_s", "capture_overlap_share_of_load",
                "load_bytes_counter", "leaf_bytes", "tokens_equal_serve", "launches_per_step",
                "ms_per_decode_step")},
            "c_readers": {w: [[x["seconds"], x["read_bytes"], x["slice_bytes"],
                               x["job_peak_bytes"], x["rss_peak_growth_mb"], x["wall_s"],
                               x["vmhwm_base_mb"], x["vmhwm_mb"], x["ru_maxrss_mb"]]
                              for x in v["ranks"]]
                          for w, v in stream["c_readers"].items()}},
        "serve_tune_llama3-8b": {
            "arms": {n: {k: a.get(k) for k in ("tok_per_s", "ms_per_decode_step", "ttft_ms")}
                     for n, a in tune["arms"].items()},
            **{k: tune[k] for k in ("winner", "tuned_cell_levers", "tokens_equal_serve",
                                    "ms_per_decode_step_http")},
            "layer_profile": {k: tune["layer_profile"][k] for k in (
                "components", "errors", "seconds", "decode_ms")},
            "replay_16_event_ms_per_step": tune["replay_16"]["event_ms_per_step"]},
        "serve_ckpt_llama3-1b": {k: ckpt[k] for k in (
            "seconds", "ready_s", "ready_s_materialized", "hf_bytes", "quant_bytes",
            "a_leaves_bitwise",
            "scalar_divisor_scales", "b_leaves_bitwise", "c_tokens_equal", "d_tokens_equal",
            "launches_per_step", "ms_per_decode_step", "optional_packages")},
        "serve_ckpt_readers": {w: [[x["seconds"], x["read_bytes"], x["slice_bytes"],
                                    x["job_peak_bytes"], x["rss_peak_growth_mb"], x["wall_s"]]
                                   for x in v["ranks"]] for w, v in ckpt["readers"].items()},
        "serve_orbax_llama3-1b": {
            **{k: orbax[k] for k in ("ready_s", "launches_per_step", "ms_per_decode_step",
                                     "b_tokens_equal_memory")},
            "fixture": orbax["a_fixture"], "write": orbax["llama_write"],
            "load": {fmt: {k: b[k] for k in ("read_s", "disk_s", "decode_s", "upload_s",
                                             "quantize_s", "load_bytes_counter") if k in b}
                     for fmt, b in orbax["boot"].items()},
            "embed_bge-base": {k: orbax["c_embed"][k] for k in (
                "bitwise_equal", "ready_s", "write_s", "bytes_on_disk")}},
        "serve_tp_llama3-8b": {
            "a_k1_ms_per_step": {w: v["k1_ms_per_step"] for w, v in
                                 tp["a_shards"]["worlds"].items()},
            "a_k1_bound_ms_per_step": {w: v["k1_bound_ms_per_step"] for w, v in
                                       tp["a_shards"]["worlds"].items()},
            "a_dequant_routes": {w: v["dequant_routes"] for w, v in
                                 tp["a_shards"]["worlds"].items()},
            "b": {k: tp["b_serve"][k] for k in ("ms_per_decode_step", "decode_tok_s",
                                                 "launches_per_step", "tokens_equal_serve",
                                                 "group_profile")},
            "serve_ms_per_decode_step": serve8["ms_per_decode_step"],
            "serve_decode_tok_s": serve8["decode_tok_s"],
            "c_exit_code": tp["c_overgrant"]["exit_code"]},
        "serve_tp_cells": {
            "a_k2_ms_per_step": {w: v["k2_ms_per_step"] for w, v in
                                 tpc["a_shards"]["worlds"].items()},
            "a_k2_bound_ms_per_step": {w: v["k2_bound_ms_per_step"] for w, v in
                                       tpc["a_shards"]["worlds"].items()},
            "a_k1_ms_per_step": {w: v["k1_ms_per_step"] for w, v in
                                 tpc["a_shards"]["worlds"].items()},
            "a_dequant_routes": {w: v["dequant_routes"] for w, v in
                                 tpc["a_shards"]["worlds"].items()},
            "b_mixtral": {k: tpc["b_serve"][k] for k in (
                "ms_per_decode_step", "decode_tok_s", "launches_per_step",
                "tokens_equal_serve_moe")},
            "serve_moe_ms_per_decode_step": serve_moe["ms_per_decode_step"],
            "c_embed_bitwise_equal": tpc["c_embed"]["bitwise_equal"],
            "d_exit_codes": {m: v["exit_code"] for m, v in tpc["d_overgrant"].items()},
            "e_expert_reader_t8": [[x["seconds"], x["slice_bytes"], x["job_peak_bytes"],
                                    x["rss_peak_growth_mb"], x["wall_s"]]
                                   for x in tpc["e_expert_reader"]["ranks"]]},
        "serve_embed_bge-base": {k: embed[k] for k in (
            "seq_per_s", "tokens_per_s", "burst_ms_p50", "cosine_to_f32_min",
            "alone_vs_in_grid")}}})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
