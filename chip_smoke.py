#!/usr/bin/env python3
"""Drive the PyTorch port's sketch plane on one NVIDIA card and check it.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

(`python3 chip_smoke.py --poll ...` is the query_plane phase's child
process of pollers, and `python3 chip_smoke.py --dist-rank ...` a rank
of the distributed phase; nothing else runs them.)

It builds the CUDA kernels of the port from `netobserv_tpu_torch/csrc/` (nine
C entries: kernels 1-8 and the HLL folds launch) and the empty kernel of
the launch floor (one `nvcc` per source, all started together), holds each
against its plain PyTorch version at the shapes its path gives it, then
drives five
paths through `TorchSketchExporter` at the default geometry (and seven
planes on the lanes path after them: the fused drain's seam, the window
thread, the query and federation planes, the exporters over the port's
own gRPC transport, the archive and overload control; and, host only,
the embedded flowlogs-pipeline and packet capture),
each with the
launch counts set to 0 just before it and read just after:

- the wide main path, `SketchConfig()` through the dense feed
  (`fold_dense`; kernels 1, 2 and 4, and the HLL folds launch, which runs
  kernels 3 and 8's one body on the global HLL and both grids): 2 windows
  x 32 folds of 16,384 records of the seeded bench traffic;
- the tiered path, `SketchConfig(tiered=TierSpec())` (kernels 2, 6 and 7,
  and the folds launch on the two grids): the same 2 windows, then one
  window of DECAY_FOLDS folds rolled in decay mode, so the tier-level
  decay runs on the card;
- the resident path, `SketchConfig()` through the resident feed at one
  lane and the ladder (1,) (`fold_events`; the wide path's kernels): the
  same 2 windows of the same batches as flow events
  (`traffic.event_pool`), default caps for B = 16,384 and 2^18 slots, the
  bytes of the one-lane `ResidentStagingRing`. It also checks the key
  table on the card against the host dictionary and prints the pack time
  apart from the rest, the bytes copied to the card per record, and the
  ring's counters;
- the lanes path, the reference agent's default feed
  (`exporter/tpu_sketch.py:1575-1612`): 8 lanes of 2,048 rows (the auto
  pack threads of an 8-CPU node, set explicitly), the superbatch ladder
  (1, 2, 4) and 2^18 slots a lane, fed the same records as evictions
  (`export_evicted`) of EVICT_ROWS rows three times in four, else of
  40,000-70,000 (`LaneFeeder`, sizes from `numpy.random.default_rng(1)`),
  each window rolled after its 32 x 16,384 records. It checks that every
  ladder entry folded, one capture each (all three captured when the ring
  is made), every lane's key table against its dictionary, and that
  evictions took the pending buffer's direct path; it prints records/s,
  pack and ingest seconds per 16,384 records, the lanes and
  `os.cpu_count()`;
- the fused drain's seam (`fused_drain`, ROADMAP A7: `datapath/loader`'s
  gate, `csrc/flowpack.cc` `fp_drain_to_resident`,
  `ShardedResidentStagingRing.fold_packed`), at the lanes path's
  geometry (LANES_KW) on the integer copy of its stream
  (`_integer_stream`), cut as `_stream_evictions` cuts it, 2 windows x
  32 x 16,384 records. Each eviction becomes a drain's injected maps
  (`_split_maps`: the aggregation map and per-CPU extra, DNS and drop
  maps at FD_CPUS CPUs whose integer partials merge to the records'
  values, about FD_ORPHANS of the feature rows orphans), drained by a
  `NativeEvictPipeline` over a duck-typed fetcher (fd < 0, FD_LANES
  lanes) bound to the exporter's `resident_pack_surface()`: drain 1 runs
  the Python chain (`decode_eviction`), every later drain is fused and
  rides `export_evicted` with `packed`. Three runs: the raw chain (the
  Python chain into the unfused lanes ring) and the fused one, each
  timed over window 0 and profiled over window 1 (the device's busy
  share), their launches a fold's per dispatch (no kernel falls back:
  no plain version runs), one capture a ladder entry and no retrace;
  then a checked run, a fused exporter beside a raw twin of its
  settings: each fused drain's events and features byte for byte
  against the Python chain of the same maps, each arena byte for byte
  against the twin ring's own pack of the same rows (`_ShipRecorder`),
  both windows' pre-roll tables bit for bit, and one raw fold between a
  pack and its ship (the arena discarded for its stale epoch,
  `outstanding` back to 0, its rows refolded raw, the twin's
  dictionaries given the same epoch roll). It prints records/s fused
  and raw, host ms per 16,384 records in the chain (to the eviction in
  hand, less the injection of the rows, the stand-in for the kernel
  drain's copy, printed apart) and in `export_evicted`, the native
  call's split into drain,
  merge, join and pack (`decode_stats["native"]`) against the raw
  chain's merge and align and its ring's pack, `fold_packed` ms, the
  busy share, the lanes, `os.cpu_count()`, spill rows, dictionary
  resets and segments;
- the kernel datapath (`kernel_datapath`, ROADMAP A8.3 and A8.4's first
  half: `datapath/asm*.py`, `syscall_bpf.py`, `loader.BpfmanFetcher` and
  `MinimalKernelFetcher`), in three parts. (1) Always: every program of
  the port's builders at fixed arguments (`kd_program_args`: both
  directions of the flow program bare and with every feature's fds, the
  RTT and drop probes with and without the sampling gate, SSL write,
  PCA), each against the reference builders' SHA-256 (KD_PROGRAM_SHA256,
  which `tests/test_torch_asm.py` holds against them), and the probes at
  the live kernel's offsets where tracefs is mounted and vmlinux BTF
  exists; an earlier line prints each program's instruction count and
  SHA-256. (2) Where bpf(2) may create maps and bpffs is writable: the
  maps bpfman would pin (`aggregated_flows` of KD_CAPACITY, per-CPU
  `flows_extra`, `flows_dns` and `flows_drops` over every possible CPU,
  `global_counters`), pinned under a directory of the phase's own and
  filled by BPF_MAP_UPDATE_BATCH (`bpf_update_batch`) with the
  fused_drain phase's evictions of EVICT_LARGE rows, each key once (a
  repeat takes another source port), split as `_split_maps` splits them
  over the possible CPUs. A timed run drains them with
  `BpfmanFetcher(native_pipeline=True, drain_lanes=KD_LANES)` bound to a
  lanes exporter's pack surface (the gate asserted engaged: drain 1 the
  Python chain, every later one fused), another with the raw fetcher
  (`native_pipeline=False`), each drain and export timed between two
  synchronizations, the fill not; launches a fold's per dispatch, no
  plain version, no capture or retrace; then a checked run, the fused
  and raw drains of each content in lock step into a fused exporter and
  a raw twin, each fused drain byte for byte against the raw one and
  each half's tables bit for bit. It prints per 16,384 records the
  native call's drain, merge, join and pack ms (the raw chain's merge,
  align and decode), records/s and the busy share, beside this run's
  fused_drain figures over injected maps, and unpins everything, also on
  failure. (3) Where the process is also root, `tc` is present and the
  kernel has TCX: `MinimalKernelFetcher` (DNS on, so its gate has a map)
  through the verifier, attached by TCX (no qdisc, no device made) to
  the loopback device on both directions, KD_LIVE_PER_PORT datagrams to
  each of KD_LIVE_PORTS on 127.0.0.1, drained into a lanes exporter:
  every flow captured with its packets and bytes as sent, counted once a
  pass of a hook (twice a datagram on the loopback device), and the
  window's records those drained; detached and closed in a `finally`.
  A part whose probe says no prints one line naming the missing
  capability (`bpf(2): EPERM`, `not root`, `no tc`, `no tcx`) and does
  not run; once a probe says yes, any failure of the part fails the
  script;
- the window thread (`window_thread`), the lanes path's exporter with its
  window thread on (`window_s` = WINDOW_S), a metrics registry where
  `prometheus_client` imports, tracing at sample 1.0 and a sink that
  takes SINK_SLEEP_S a report, fed the lanes path's eviction stream for
  about WT_SECONDS of wall (then on until the last eviction lands in a
  window with WT_MARGIN_S left). In its third window one fold's first
  dispatch raises after its chunk packed (a seam of this script that
  wraps the ring's ladder entry, not a fault point of the package): the
  exporter must contain it (one ingest error, every lane dictionary's
  epoch rolled, no new capture), every report must reach the sink once
  and in order, `close` must publish the last partial window, the
  reports' records must sum to the rows fed less the dropped fold's, and
  every lane's key table must match its dictionary after it. The run is
  then replayed eagerly with the plain versions (`window_s=None`), with
  the same failure and a roll after the same evictions as each roll of
  the window thread: each window's pre-roll tables are held against
  their twin under the whole-window bounds below, its report's Records
  and Bytes exactly, and its heavy hitters to recall@100 >= 0.99 against
  the exact oracle of the window's rows. It prints records/s, the
  longest and median `export_evicted` time and the longest while a sink
  call was in progress, and each window's roll and publish spans;
- the query plane (`query_plane`), the lanes path's exporter with its
  window thread on (QP_WINDOW_S windows), a mid-window refresh every
  QP_REFRESH_S (a quarter of the window), QP_HISTORY closed windows kept
  for `?window=`, an alert engine under `default_rules()` with the log
  sink, the port's metrics server (`serve`) and debug server on
  ephemeral ports of 127.0.0.1, fed the lanes path's eviction stream (its
  ICMP type and code zeroed, so that a 5-tuple names each key) for about
  WT_SECONDS. Four pollers, threads of a child process of this script
  (`--poll`, so their client work does not share the exporter's
  interpreter lock), ask `/query/topk`, `/query/frequency` (the stream's
  top key by bytes), `/query/cardinality`, `/query/victims`,
  `/query/churn`, `/query/status`, `/query/alerts`, a `?window=` read 1-10
  windows back and `/debug/executables`, in a loop. It checks: every
  answer 200, but 503 before the first publish and 404 for a `?window=`
  evicted from the ring; no poller sees (window, seq) go back, of the
  snapshot routes or of the alert view; every window one closed snapshot,
  and each window the timer closed a mid-window one; each closed window's
  Records equal to the rows fed in it, its Bytes and every row sum of its
  `cm_bytes` within 2 * n * 2^-24 relative of the bytes fed (n its rows);
  `/query/frequency` on each window of the ring at least the exact bytes
  of that window's top key less the same bound; a refresh with the folds
  paused leaves the live `state_tables` bit-identical; no capture or
  retrace, the launches of the folds made, no plain version. It prints
  each route's p50 and p99 latency (from each poller's second turn; the
  first turn's longest apart), the refreshes with the exporter lock
  held and their whole time (median, max), the roll's added CM-plane copy
  (synchronized, then timed), the longest `export_evicted` while a
  refresh ran, and records/s beside `window_thread`'s;
- the federation plane (`federation`): one `FederationAggregator` at the
  default geometry (its merge captured as one CUDA graph when it is made,
  before any other capture or thread, an alert engine under the default
  rules, a list sink) and FED_AGENTS lanes-path agents
  (`TorchSketchExporter`, `agent_id` agent-0 to agent-3, `delta_sink`
  the aggregator's `ingest_frame`), each folding its seeded quarter of
  the lanes path's stream as evictions, two windows closed by `flush()`.
  Then a fan-in: FED_IDS sources per live agent, each live frame
  re-headered (`federation/pbwire.py`) under its own agent id with a
  fresh uuid, 256 frames a window for FED_FANIN_WINDOWS windows (some
  1.1 GB of tables a window). Inside the first fan-in window a
  redelivered frame must ack `duplicate`, a stale one `stale`, a v2 frame
  `ok` with zero churn tensors and a v1 frame merge `legacy`; a
  truncated frame and one of another geometry are rejected with every
  table unchanged. Each cluster window's added tables (CM planes,
  histograms, rates, `synack`, `drop_causes`, `dscp_bytes`, `conv_*`,
  scalars) must equal a host numpy replay of the same f32 adds in the
  same frame order bit for bit, its HLL banks the elementwise max, and
  every table (the heavy table included) an eager replay of
  `statemerge.merge_tables` on the card; each live cluster report's
  Records the sum of the agents'; `federation_merge` one capture, no
  retrace, the agents' launches those of their folds. It prints the
  frame bytes raw and zlib, `ingest_frame` p50/p99 split into decode,
  host-to-device copy and merge dispatch (spans of the delta traces),
  the merge's device time and kernels per replay (torch.profiler), fan-in
  frames/s, the cluster flush (roll and publish) ms, each agent's
  `roll_dispatch` on empty windows with a delta sink (the whole
  `state_tables` copied under the lock) and without, and the agents'
  records/s beside `window_thread`'s;
- the record exporters and the port's own gRPC transport (`exporters`,
  ROADMAP A8.7: `exporter/grpc_flow.py`, `ipfix.py`, `stdout_json.py`,
  `pb_convert.py`, `exporter/federation.py`, `grpc/h2.py`, `pb/flow.py`),
  in three parts. (a) EXP_RECORDS records of the lanes stream
  (`records_from_events`), seeded into v4 and v6 keys, ICMP, DNS, drops,
  xlat, TLS, QUIC, IPsec and network events: through `GRPCFlowExporter`
  into the port's `start_flow_collector` at 2 flows a message (the first
  EXP_SMALL) and at 10,000, each received record equal to its original
  in every field pbflow carries; where `openssl` is on PATH the same over
  TLS with a self-signed certificate (EXP_UDP records), else one printed
  skip line; `IPFIXExporter` over UDP (EXP_UDP records) and TCP to local
  sockets, decoded here: the templates the IANA elements of
  EXP_IPFIX_TEMPLATES, each header's sequence number the data records
  before it, every field the record's; `StdoutJSONExporter` into a
  buffer, each line `to_json_obj`. It prints each backend's flows/s and
  wire bytes a flow. (b) `python3 -m netobserv_tpu_torch` as a child
  with EXPORT=grpc (the DaemonSet's setting) to the port's collector and
  no DATAPATH (the synthetic rung where bpf(2) fails): Started on
  /healthz, flows at the collector before SIGTERM, exit 0; it prints the
  time to Started and the flows. (c) FEDERATION_TARGET: FED_AGENTS
  lanes-path agents from `TorchSketchExporter.from_config` fold seeded
  quarters of the integer stream (`_integer_stream`, so add order cannot
  change a bit), two windows closed by `flush()` from this thread. First
  in process (each agent's sink swapped for the aggregator's
  `ingest_frame`), then over the wire: an aggregator at the default
  geometry, the agents' rings captured, then the port's
  `start_federation_collector` on the port the agents were given. Every
  cluster window equals the in-process run's bit for bit, its records
  the agents' sum; the launches are the folds' (kernels 1, 2, 4 and the
  folds launch), no plain version runs, no ring captures again. Then
  EXP_PUSH_ROUNDS rounds of the live frames re-headered under fresh ids,
  each pushed over the wire and handed to `ingest_frame` in process, and
  three failures: a cold start (a sink made before its server exists
  delivers once it appears), a server without Push (UNIMPLEMENTED, one
  attempt, counted `terminal`) and a raw frame over 4 MiB
  (RESOURCE_EXHAUSTED, classified `retry`). It prints the push p50/p99
  over the wire beside `ingest_frame`'s, the wire bytes a frame and
  frames/s;
- the embedded flowlogs-pipeline and packet capture (`flp_pca`, ROADMAP
  A8.7b and A8.8: `exporter/direct_flp.py`, `flp_map.py`, `flp_tables.py`,
  `flp_enrich.py`, `pb/packet.py`, `grpc/packet.py`,
  `exporter/grpc_packets.py`, `flow/perf_buffer.py`,
  `agent/packets_agent.py`, `datapath/replay.PcapPacketFetcher`,
  `datapath/loader.load_packet_fetcher`), host only: no kernel launches,
  checked. (a) In process, the port's `FlowsAgent` with EXPORT=direct-flp
  (`build_exporter`, the agent's metrics registry) over a
  `PcapReplayFetcher` of a seeded `scenarios/synth` pcap of FLP_CONNS TCP
  connections (both directions, so at least 2 * FLP_CONNS records),
  evicting every FLP_EVICT_S; FLP_CONFIG (FLP_CHIP_CFG) holds a filter, a
  network transform (`add_subnet`, `decode_tcp_flags`), a bidirectional
  conntrack, a prom encode and `write grpc` into the port's
  `start_flow_collector`. The conntrack clock is patched (`_FlpClock`,
  FLP_CLOCK_STEP_S a batch); the agent's batches are recorded and then
  replayed on the CPU through a second `DirectFLPExporter` of the same
  configuration under the same clock into a second collector: the
  collectors' messages equal byte for byte, the `flp_` prom samples equal,
  one endConnection for each newConnection. It prints records/s through
  `export_batch` and the entries the collector got. (b) An
  EXPORT=direct-flp `python3 -m netobserv_tpu_torch` child with no
  DATAPATH: Started on /healthz, exit 0 on SIGTERM; it prints the time to
  Started. (c) An ENABLE_PCA child with `DATAPATH=pcap:` over a seeded
  pcap of PCA_FRAMES UDP frames of 64 to 1,514 bytes into the port's
  `start_packet_collector`: the stream is the pcap file header, then
  each frame truncated at MAX_PAYLOAD_SIZE with its captured and original
  lengths, its stamp the file's offset rebased to the wall clock (each
  base between the child's start and the last arrival; the spread of the
  bases printed: the tracer reads its two clocks one after the other);
  exit 0 on SIGTERM; the same over TLS where
  `openssl` is on PATH (else one printed skip line). It prints packets/s
  at the collector. (d) `load_packet_fetcher`: where bpf(2) answers
  ENOSYS, it prints the error and marks the part not run; any other
  failure fails the phase. `flp_pca` joins the `kernels` line's
  `launches_by_path` with 0 launches;
- the archive and checkpoint planes (`archive`): an `archive.SketchArchive`
  at the default geometry (ARC_RAW raw windows a level, groups of
  ARC_GROUP, ARC_LEVELS levels, a ladder to ARC_LADDER), its merge ladder
  captured when it is made (one CUDA graph an entry), before the agent's
  ring; then one lanes-path agent that checkpoints every roll and
  archives every window, ARC_WINDOWS windows of ARC_ROWS records of the
  lanes stream closed by `flush()`, fed as evictions by a thread of their
  own (window w + 1's once window w rolled, so folds run while the
  publish compacts) while another thread asks `/query/range` over raw,
  compacted and chained (past the ladder, more than ARC_LADDER segments)
  spans in turn. ARC_RAW, ARC_GROUP and ARC_LEVELS are set so that in
  ARC_WINDOWS windows both compactions (at every level) and the top
  level's retention happen, and more than ARC_LADDER segments are live.
  It checks: every range answer 200; every segment decodes with its
  header; raw segments hold the archived windows' tables; three ranges
  (5 raw segments in one dispatch, 3 padded to 4, every segment chained
  through two dispatches) bit-exact against a host numpy replay (the f32
  adds in the engine's order, the HLL maxima) and every table (the heavy
  table included) against an eager `statemerge.merge_tables` replay of
  the ladder on the card; the compacted span's CM planes within the
  add-order bound of the windows' sum, and every key's estimate within
  the widened bars (true <= est <= true + (e/w) * N, each side widened by
  2 * n * 2^-24 for the f32 sums of n records); one capture per ladder
  entry and of each agent graph, no retrace, no error in either thread;
  the launches of the agent's folds; a restarted agent restores its last
  checkpoint bit for bit, in place (the same tensor addresses), and a
  restarted aggregator (checkpoint every roll) its state and ledger (a
  redelivered frame then acks duplicate). It prints segment encode and
  decode ms, the archive write and compaction ms, the ladder graphs'
  CUDA-event ms (x1, x16), range p50/p99 by span kind, the roll's lock
  hold on empty windows with the archive and checkpoint and without,
  the checkpoint's host copy (under the lock) and write (off it), the
  restores, and `export_evicted` ms (median and longest of the run);
  then a thread folds the stream's evictions while ARC_CONTEND more
  windows are archived straight through the archive, and it prints
  `export_evicted` ms while a compaction ran and apart from one;
- overload control (`overload`), at the default geometry on the lanes
  feed, its evictions drawn as the lanes path draws them. (1) The same
  OV_EVICTIONS evictions of an integer-mass copy of the stream (bytes
  1-63, packets 1-3, drop bytes 0-63 and packets 0-3, unsampled: no
  per-cell f32 sum passes 2^24) through an exporter with no controller,
  one armed but idle (`shed_watermark=1e9`) and one idle behind the
  overlapped fold thread (`overlap_depth=2`): the same tables bit for bit.
  (2) A shed pinned at 4 (`shed_seed=1`) over the same evictions:
  captured equal to an eager replay with the plain versions bit for bit;
  the exact top-12 keys' CM estimates within 2e * total / width + 4 sigma
  of the unshed run's, their mean signed relative deviation within
  0.15, and recall of the exact top-8 at most 0.25 below the unshed
  run's. (3) An overdrive: `shed_watermark=2.0`, `shed_max=64`,
  `overlap_depth=2`, OV_WINDOW_S windows, a delta sink, registered with
  the port's `agent/supervisor.Supervisor` and served by the port's
  metrics server with a health source built as the reference agent's; a
  producer thread offers the lanes stream's evictions as fast as
  `export_evicted` returns for OV_DRIVE_S (held on, at most 3 s more,
  until the factor is above 1), then stops. It checks: the
  factor rises above 1; `overloaded` active in the supervisor's
  conditions and in `/healthz`'s body over a socket, `/readyz` 200; the
  pending buffer within its capacity; every window's report published
  once; a delta frame carrying the factor and OVERLOADED; the factor at 1
  within one clean window (two rolls) of the stop; the launches of the
  folds made, no new capture, no retrace, no thread or ingest error. It
  prints offered and admitted records/s, the factor's maximum and seconds
  above 1, the shed rows and batches, the busy EWMA, the slot-wait p95,
  `export_evicted` p50/p99/max through the handoff and, for OV_SYNC_S of
  the same feed, synchronously. (5) Supervision: the fold thread
  stopped as tests/test_overlap.py stops it (which stops the window
  thread too), two evictions handed off, the supervisor revives both and
  the handoff drains (`stage_restarts_total{stage="sketch-fold"}`); then
  a window closed under the lock with a crash armed at the window
  thread's `sketch.window_timer`: the thread restarts and the queued
  report publishes exactly once. (4) A wedged stream: the slot-wait
  budget at OV_BUDGET_S, a spin of about OV_SPIN_S (`torch.cuda._sleep`,
  a test tool of torch's, no kernel of the port) enqueued on the
  exporter's stream between folds of the integer stream, then folds on:
  the first trip within `n_slots` slot waits of the spin, each fold that
  trips back within the budget plus 0.2 s, one
  `sketch_ingest_errors_total` a trip, no dictionary epoch rolled, no
  CUDA error after it, folds after the spin; and the tables equal bit for
  bit to an eager replay with the plain versions fed the same evictions,
  a never-ready copy event standing in at the same slot waits. Every
  number prints beside the card's name and power limit (`card`);
- the agent entry (`agent_entry`). (a) In process: a `FlowsAgent` of
  the port built from `config.load_config` (EXPORT=tpu-sketch,
  SKETCH_BATCH_SIZE=16384, 1 s windows, a CACHE_ACTIVE_TIMEOUT of AE_TICK,
  the default geometry and lanes) over the port's `FakeFetcher`, which a
  feeder thread keeps supplied with the lanes path's eviction stream
  (`_stream_evictions`), at most AE_BACKLOG evictions ahead of the
  exporter, for AE_SECONDS; then the agent stops as SIGTERM stops it (the
  map tracer's final eviction, the drains, `close`). It checks: the
  folds' launches (kernels 1, 2, 4 and the folds launch), no drop, no
  ingest error, no new capture or retrace, the reports' Records summing
  to the rows fed, every lane's key table against its dictionary, and
  each window's pre-roll tables against an exporter fed the same
  evictions in the same order and rolled after the same ones: under the
  whole-window bounds of `window_thread` against an eager replay with the
  plain versions on the production stream, and bit for bit against a
  captured exporter on an integer-mass copy of it (AE_INT_SECONDS at
  AE_INT_RATE records/s, so that no per-cell sum passes 2^24). It
  prints records/s from the first eviction to the last report beside the
  lanes path's direct `export_evicted` rate and `window_thread`'s, and
  per eviction the spans `evict` (the map tracer's drain), `limiter`
  (evicted queue to export queue), `export_wait` and `export` (the
  terminal's call). (b) As a process: a pcap built with the port's
  `scenarios/synth.py` (a SYN flood on 10.0.0.80, a port scan, an
  elephant) replayed by `python3 -m netobserv_tpu_torch` as a child on
  the card (DATAPATH=pcap:..., METRICS_ENABLE on a free port, 1 s
  windows): `/healthz` and `/readyz` 200 with status Started, `/metrics`
  with the eviction families, `/query/status` 200, the flood in a
  report's SynFloodSuspectBuckets with its victim named, the reports'
  Records and Bytes equal to the replay fetcher's own totals, SIGTERM
  ending it with exit 0 within 15 s after publishing its last window;
  then a DATAPATH=synthetic child that starts, answers `/healthz` and
  stops on SIGTERM; then one with no DATAPATH, INTERFACES=lo, no
  EXCLUDE_INTERFACES (whose default is lo) and LISTEN_INTERFACES=poll
  (its own namespace's links only), which takes the reference's
  ladder (`agent.build_fetcher`) to the rung this machine allows
  (`_expected_rung`: the hand-assembled datapath where the child is root
  and bpf(2) and bpffs answer (`_kd_probe_bpf`), else synthetic replay):
  its log shows the clang-object line, then the provisioning of the
  assembler datapath or the fallback warning carrying the minimal rung's
  error; it attaches to nothing but lo in its own namespace, answers
  `/healthz` 200 Started, exports flows, publishes reports with Records >
  0 folded on the card and exits 0 on SIGTERM; where that rung fails, a
  DATAPATH=kernel child exits non-zero with the rung's error on its
  standard error. It prints
  each child's start-to-Started and SIGTERM-to-exit times;
- interface discovery and the SSL, UDN and network-events branches
  (`ifaces_features`, within IF_BUDGET_S): (a) the port's
  `ifaces/netlink.dump_links()` against the names and indices of a
  listing made without netlink (`_link_witness`: `/sys/class/net`, else
  `/proc/net/dev`'s names through `if_nametoindex`, else libc's
  `if_nameindex`; where the machine refuses the netlink socket, the errno
  is printed and (a) is reported as not run, as it is where no witness
  exists); (b) an `InterfaceListener` over a `Poller` (where netlink is
  refused, over IF_SCRIPTED_LINKS, named so) with a recording fetcher
  that asks for discovery, INTERFACES=/./ and EXCLUDE_INTERFACES of lo
  and one more: it attaches exactly the up interfaces the pair allows,
  `interface_events_total` counts each added and attached, and stop
  restores the default namer; (c) a `FlowsAgent`
  with the ring-buffer fallback on the card's sketch exporter, taken on
  its record path, with ENABLE_OPENSSL_TRACKING, ENABLE_UDN_MAPPING (a
  UDN_MAPPING_FILE) and ENABLE_NETWORK_EVENTS_MONITORING (no OVN socket),
  fed by a `FakeFetcher` in a fixed order (IF_SSL_EVENTS SSL writes, each
  handled; IF_RB_EVENTS singles, each accounted; one map eviction of
  IF_MAP_ROWS flows; everything evicted at stop): its tables bit for bit
  and its report equal those of the same run without the three settings,
  the SSL credits on its records and their UDNs equal a CPU run's, the
  static OVN decoder installed and removed, the `ssl-tracer` stage
  registered, the folds' kernels launched and no plain version run; its
  runs keep FORCE_GARBAGE_COLLECTION at its default and print the full
  collections each made and their seconds;
- the scenario zoo (`scenarios`): first each kernel of the zoo's path
  (kernels 1, 2, 4 and the folds launch, and kernels 3 and 8 cut from
  the folds launch's calls) against its plain twin at the zoo's shapes:
  the pcaps of ZOO_KERNEL_SCENARIOS evicted as the replay fetcher evicts
  them into an eager exporter of the runner's geometry (CM 4 x 16,384,
  HLL p = 12, K = 256) and batch (ZOO_BATCH = 512, so 544 rows a fold
  with the resident feed's spill rows) running the plain versions, every
  wrapper call recorded, the first, middle and last call of each
  compared in the production and the integer regime under the kernel
  phase's bounds. Then all nine scenarios of `scenarios/zoo.py`, one
  after another, through the port's `scenarios/runner.run_scenario` on
  `cuda:0`: each replays its pcap through a full agent (replay fetcher,
  map tracer, limiter, terminal, the exporter's captured resident feed
  with the mid-window refresh and the default alert rules, the metrics
  server) and grades it through `/query/*` over HTTP; each agent stops
  and closes its exporter before the next one captures its ring (C4).
  It prints a line a scenario (grade, failures, alarms fired, alerts
  raised, time to detect, retraces, seconds, folds, captures and
  launches a fold, a capture's warm-up counted as one) and fails unless
  every grade passes with 0 retraces, every launch count is the
  resident path's per fold and no plain version ran;
- the ring-buffer fallback (`ringbuf`): a `FlowsAgent` from
  `config.load_config` with ENABLE_FLOWS_RINGBUF_FALLBACK=true at the
  default geometry and batch and the default CACHE_MAX_FLOWS (5,000) and
  CACHE_ACTIVE_TIMEOUT (5 s), over the port's `FakeFetcher`, fed
  RB_EVENTS single-packet events over RB_FLOWS Zipf RB_ZIPF flows
  (`_rb_events`, seed RB_SEED) through `inject_ringbuf`, at most
  RB_BACKLOG events ahead of the accounter, so neither the tracer's
  queue nor the evicted queue drops. It checks `ringbuf_events_total`
  against the events injected, no drop, evictions both at
  CACHE_MAX_FLOWS and on the timeout, every flow's bytes and packets
  over the accounter's evictions against the injected sums, the
  window's report, the launches (the record path's captured fold), and
  the pre-roll tables bit for bit against a CPU exporter of the same
  settings fed the same record lists through `export_batch` (the whole
  stream stays below 2^24 bytes, the integer regime). It prints events/s
  through tracer and accounter and the seconds of the terminal's
  `export_batch` calls;
- the tenant planes (`tenants`, SKETCH_TENANTS: `sketch/tenancy.py`, N
  tenant states stacked on a leading axis, one captured graph a tenant
  count folding every tenant's rows). (a) The ladder of the reference's
  `bench.py:1151-1243` at the default geometry, TN_B rows a tenant, N in
  TN_LADDER: the stacked arm (a `TenantStack`, each dispatch one copy of
  every tenant's rows to the card and one replay, through the stack's own
  `_dispatch`) against a sequential arm (N single-tenant captured folds
  of the same rows, each with its own copy from pinned buffers made
  once), TN_ITERS dispatches after TN_WARMUP; then TN_CHECK dispatches of
  the stacked graph on a fresh state, every tenant's tables bit for bit
  against its eager plain folds of the same rows (integer masses). Then
  the router's block (`bench.py:1245-1275`): TN_RECALL's Zipf rows
  through `fold_rows` at N = 8, B = 256, every tenant's recall@100
  against its exact oracle (>= 0.99) and its tables bit for bit against
  an eager stack of the plain versions (byte masses whose per-cell sums
  stay below 2^24). It prints records/s of each arm and their ratio, the
  stacked dispatch's CUDA-event ms, its launches by kernel (N times a
  single fold's), the capture seconds and the graph pool's bytes (a pool
  a rung; `memory_reserved` across the capture, the cache emptied
  first). (b) The exporter
  `load_config` builds for SKETCH_TENANTS=TN_EXP_N at the default
  geometry and B = 16,384 (its windows closed by `roll()`), with a
  callable delta sink set on it, fed the lanes stream's evictions
  (`_stream_evictions`) for TN_EXP_WINDOWS windows: every tenant's
  Records exact (the router's count of the stream), the launches N times
  a fold's per stacked dispatch, no capture or retrace,
  `/query/topk?tenant=3` the tenant's report and the 400/404 contract,
  the frames 8 a window with their `TenantInfo`; each tenant's pre-roll
  tables (its frame) within the whole-window bounds of a plain routed
  replay (an eager exporter of the same tenants under the plain versions,
  each tenant's per-cell adds counted on its own), heavy identities
  equal; an integer-mass copy of one window bit for bit against its plain
  replay; one tiered window (SKETCH_TIERED), kernels 6 and 7 N times a
  dispatch, Records exact. It prints records/s (with and without the
  rolls' time), the router's host ms per 16,384 rows (`route` and the
  per-tenant selection), the roll's lock hold and each `roll()`'s
  seconds (the publish of 8 reports and frames included), and the
  stacked dispatches. (c) Fault C14's record path (`_record_path`):
  C14_RECORDS integer-mass records of the lanes stream through
  `export_batch` of a tenants=TN_EXP_N exporter on the card and on the
  CPU, every tenant's tables bit for bit, the reports' records and
  bytes equal; it prints the card's ms per 16,384 records;
- the mesh (`mesh`, `parallel/`: one process drives a (data, sketch)
  grid of devices, each shard folding its rows into its own partial, the
  cross-shard merge at the roll), on MESH_SLOTS devices taken round robin
  over the visible cards (`cuda:0` four times on one card, so nothing
  here measures a link between cards). (a) A 4x1 and a 2x2 mesh, the
  pool's dense batches copied as they are into a `DenseStagingRing` on
  the mesh (one captured graph of every shard's fold a device), 2
  windows x 32 dispatches, each window rolled through
  `parallel/merge.make_merge_fn`: the 4x1 merged tables within the
  whole-window bounds of one card's plain wide fold of the same batches
  (the window totals within the add-order bound of the window's rows;
  the heavy tables' identity overlap printed, since the merge
  re-selects from four local tables), the 2x2 shards' tables against an
  eager plain replay of the same mesh, recall@100 >= 0.99 on both
  against the exact oracle, an integer-mass copy of MESH_INT_FOLDS
  batches bit for bit against one card's captured fold, one capture a
  graph, no plain version run, and the launches: a wide fold's per shard
  fold, kernel 1's traded for two of kernel 5 on the 2x2 mesh. It prints
  wall and CUDA-event device ms per 16,384 records, the main path's wall
  beside them, and each roll's ms with its merge. (b) A
  `TorchSketchExporter(mesh_shape="4x1")` on the lanes path's evictions
  (4 shards x 2 lanes, the ladder (1, 2, 4), a callable delta sink,
  checkpoints every roll), 2 windows closed by `flush()`; between them the
  state is zeroed and the checkpoint restored in place (the graphs stay
  bound) and must read back as saved; each window's frame within the
  whole-window bounds of an eager plain replay with no restore, every
  lane's key table against its dictionary, one capture a ladder entry, no
  retrace; it prints records/s. (c) A 4x1 `FederationAggregator` and one
  on one card, made before any agent's ring, over the frames of FED_AGENTS
  lanes-path agents (the integer-mass stream split by a seeded owner), 2
  windows: every cluster window's CM planes and totals bit for bit; it
  prints `ingest_frame` p50, each flush's ms and the heavy tables'
  identity overlap. (d) Fault C14's record path (`_record_path`) on a
  4x1 and a 1x2 mesh, every shard's leaves (`dist_tables`) bit for bit
  against the same mesh on the CPU. The path keys `mesh_4x1`, `mesh_2x2`,
  `mesh_exporter` (over its shard folds) and `mesh_aggregator` (the
  agents' folds) join the `kernels` line's `launches_by_path`, and kernel
  5's `launches` is its 2x2 count;
- the mesh across processes (`distributed`, `parallel/distributed.py`):
  two ranks of this script (`--dist-rank`, child processes that must
  both end within DIST_TIMEOUT_S, killed when it runs out; a rank that
  fails fails the phase), each one data shard of a 2x1 mesh that spans them, joined
  over 127.0.0.1 with NCCL and rank r on `cuda:r` where there are two
  cards or more, else gloo with both on `cuda:0` (NCCL refuses two ranks
  on one device; a line before the phase's says which ran). Each rank
  builds nothing (it loads the kernels this process built). (a) The
  pool's dense batches into a `DenseStagingRing` on the spanning mesh,
  each rank shipping its half of every batch, 2 windows x 32 dispatches,
  each window closed by the merge across ranks: both ranks' merged
  reports and tables bit for bit equal; against a one-process 2x1
  mesh's plain replay of the same batches within the whole-window
  bounds, and an integer-mass copy of MESH_INT_FOLDS batches bit for bit
  against a one-process 2x1 mesh's captured fold; recall@100 >= 0.99;
  no plain version run in a rank; each rank's launches a wide fold's per
  dispatch. (b) A `TorchSketchExporter(mesh_shape="2")` on the dense
  feed in each rank, 2 windows of DIST_EXP_BATCHES pool batches closed
  by `roll()`: its reports equal on both ranks, each window's records
  the rows fed. It prints per rank the wall and CUDA-event device ms per
  16,384 records, the roll's ms split into the local merge, the
  cross-rank step and the re-selection, the bytes each roll reduces and
  gathers, and launches per dispatch by kernel. The path key
  `distributed` (both ranks' launches) joins `launches_by_path`;
- the dense and compact rings (`dense_ring`, feeds "dense" and "compact"),
  fed flow events of a v4 pool (`traffic.make_pool(v4=True)`: v4-mapped
  keys, 5 % v6 rows a batch, the last batch a burst of 25 % past the
  compact feed's spill lane, so its dense fallback runs at least once),
  with the bytes copied to the card per record.

A last short phase folds C1_FOLDS batches under each of two tiered shapes
that the tier gates once sent to a kernel that could not launch them:
`cm_depth=25`, whose kernel-6 tile passes one block's shared memory (the
gate now sends it to the decode form: the wide path's kernels), and
`ewma_buckets=16384`, past the table width kernel 7's first design could
hold (now the interior form, kernel 7 fused). A third tiered shape,
`cm_depth=6`, has a kernel-6 fold tile of 57,312 B, past the 48 KiB a
launch gets without the function's shared-memory attribute: kernel 6
sets it at every launch, so the captured run sets it inside the capture.
Each is held against the plain run under the whole-window bounds below.

The kernels redesigned for the H100, 1 and 5 (the wide and single-plane
Count-Min folds, one warp-aggregated body of atomics into L2), 2 (the
top-K slot reduce, one thread-block cluster), 4 (the signal fold,
warp-aggregated atomics into L2), 6 (the tier-interior Count-Min fold,
the batch binned by tile), 7 (kernel 4's per-record body beside
packed-HLL tile blocks that test membership on h1 alone), and 3 and 8
with the folds launch (one warp-aggregated max body, up to three folds a
launch), are all held
bit-exact against their plain versions on the seeded contract cases of
`netobserv_tpu_torch/ops/kernels/cases.py` (empty and
one-row batches, one row past a warp's, CTA's or block's share, every row
on one slot, bucket, key or HLL register, ties in different CTAs, dead
rows, the inactive slot, table, tile and triple edges, zero values, rank
33, hashes that wrap past 2^32, several groups of equal cells in one
warp; kernel 2 also at a K of three slot tiles,
kernels 1, 5 and 6 at a width of one tile, kernel 7 at a bank of one small
tile and at a table width of 16,384), which the CPU tests hold against the
JAX package. For every
kernel the kernel phase prints the launch floor: the device time of an
empty kernel (`csrc/launch_floor.cu`) at its grid, cluster and shared
memory, for kernel 2 with its two cluster barriers, and for kernel 6 the
sum over its four launches (its memset of the bin counts left out).
The HLL folds launch runs once per fold on every path (the global HLL
and both grids on the wide and resident paths, the two grids on the
tiered path). Kernels 3 and 8, its folds as C entries of their own, run
on no path: the kernel phase checks each on its folds of the wide path's
folds call. Kernel 5 (the single-plane Count-Min fold, kernel 1's body
with one value row) runs only on a width-sharded mesh (`mesh`, the 2x2
mesh: twice a shard fold), as the reference's owner-sharded fold calls
it: the kernel phase checks it on the wide path's kernel-1 inputs, one
plane. The launches of kernels 3 and 8 print as 0 on every path beside
the kernel phase's own count.

The resident path packs with the native packer (`csrc/flowpack.cc`, host
C++ built with g++ at first use), the exporter's default. A phase before
the paths (`native_pack`) holds it against the Python packer on the first
window's batches as flow events: the same regions word for word, the
same rows consumed and the same dictionary count, chunk by chunk; it
times both.

Every path runs as the exporter runs on CUDA by default: each fold
replays a CUDA graph captured at the feed's first fold, or for a ladder
entry when its ring is made (`sketch/capture.py`), and captured again only
if what it is bound to changed (a retrace). Each path, and each C1 shape,
runs three times over the same batches: captured, eager with the
kernels (`capture=False`: the fold op by op) and eager with the plain
versions. The captured run's
tables are held against both under the whole-window bounds below (kernel
against plain, captured against eager), its launch counts (a replay adds
the launches its capture recorded; the capture's warm-up fold, on clones,
counts as one fold more) against the path's launches per fold, and its
compile watch (`utils/retrace`) must show one capture per graph, a call
per fold and no retrace; the `retrace_watch` phase prints the watch's
snapshot of each captured exporter, taken while it lived, and fails on
any retrace. The first window of a captured run holds its capture's
seconds; the second is steady state. The profile phases trace 8
folds of each path (the lanes path as 8 evictions of 4 batches, each one
k = 4 superbatch), captured and eager, check that the trace counts each
kernel of the path as often as its launch count says, and print wall and
device ms per 16,384 records, the device's busy share and, for the
resident and lanes paths, the pack seconds (the `per_fold` line sums them
up). The launch counts are per ingest dispatch, whatever its rows: a
k-superbatch is one.

Each path checks heavy-hitter recall against the exact oracle and is rerun
with the plain versions on the card to compare the tables; on the kernel
runs no plain version may run at all. Every phase prints one JSON line. Any
failure prints the phase's error and exits non-zero, with no "ok" line.
The last line on success is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Nothing is cut for time.

Times. One helper (`measure`) times a kernel, its plain version and the
library yardstick over a loop of 50 calls after a warm-up, by two clocks:
`device_*_ms` is the device time from a torch.profiler trace (the sum of
kernel and copy durations, so host launch overhead is left out) and is the
time held against the bound and printed in the `kernels` line;
`kernel_ms`, `plain_ms`, `library_ms` are CUDA-event times of the same loop
and include whatever launch overhead it cannot hide. In-place tables are
restored from the captured state before each call, and the restore's own
time is subtracted from both clocks: a device difference that is not
positive fails the phase, an event difference that is negative prints as
null (the two loops' host overhead, not the kernel, set it). A trace must
be whole, every kernel counted a multiple of the loop's calls, or the
phase fails. Kernels 6 and 7 have no library
yardstick: no single PyTorch call decodes, folds and promotes tiers, or
max-folds a 6-bit packed bank.

Bound. The larger of the bytes the function must move over 3.35 TB/s and
its f32 operations over 67 TFLOP/s (H100 SXM data sheet). Bytes are this
call's: each input read once; of an in-place table only the 32-byte
sectors that this call's non-zero values reach, read once and written once
(for kernel 6 the sectors of the base, mid and top tiers its columns fall
in; for kernel 7 also the sectors of the packed triples its valid records
reach; for kernels 3 and 8 and the folds launch the register cells of
their valid records, each lane once however many folds read it); a fresh
output written once. The kernel phase also prints the atomic count of
kernels 1 and 5 and the most atomics that land on one address as their
design makes them, one per distinct (warp, cell) of each plane's non-zero
values, beside one per (record, row) as a design without warp
aggregation makes them; kernel 6's bin sizes (the entries the hottest
tile's block walks); and the device time of kernels 1, 2, 4, 5, 6 and 7
with the hot key spread out (uniform keys), and of kernels 3 and 8 and
the folds launch with random hash lanes.
Kernel 5's library yardstick is `index_add_` on one plane; kernels 3 and
8's `scatter_reduce_` ("amax") on the flat register file, the folds
launch's one `scatter_reduce_` over its register files end to end.

Tolerances. Kernels 2, 3 and 8 and the folds launch compute maxima and a
minimum row: bit-exact, and so is kernel 7's packed HLL bank, in every
regime. Kernels
1, 4 and 5 (and kernel 7's signal tables) add f32 values with atomics, in
an order that changes from run to run: with integer-valued masses whose
per-cell sums stay below 2^24 (fresh tables, small integer masses on the
main path's indices) they are bit-exact; with the main path's own inputs
(tables warmed by earlier folds, hot cells past 2^24: the production
regime) a cell that took n adds is held to 2 * (n + 1) * 2^-24 relative of
the plain version.

Kernel 6 (the tier-interior CM fold) is bit-exact in the integer regime:
fresh tiers and small integer masses, chained over CHAIN folds so the
cascade reaches the top tier. In the production regime its bound is
derived on the tiers. A cell that took n adds in a fold has its post-fold
wide value (dec + adds) within n * 2^-24 * S of the exact sum on either
side, S the cell's exact value; with the subtraction new - dec, each
side's delta is within (n + 1) * 2^-24 * S, so the two sides' units
du = ceil(delta / unit) differ by at most
A = 2 * (n + 1) * 2^-24 * V / unit + 1 for a touched cell (0 for an
untouched one), with V = max(decoded value of both sides) * (1 + 2^-8)
+ unit >= S. Over a window, from equal tiers, A sums over the window's
folds: A = 2 * (N + F) * 2^-24 * V / unit + F, N the cell's adds and F the
folds that touched it. Base, mid and top are clamped running sums of
those units, so |d base| <= A per cell, |d mid| <= 2 * (sum of A over
the mid group) and |d top| <= 2 * (sum of A over the top group). The
decoded view, units * unit with a mid cell attributed to every saturated
base of its group and a top cell to every saturated mid, is held per cell
to unit * (A + [base saturated on either side] * (A_mid + [mid saturated
on either side] * A_top) + [base saturated on one side only] * mid_total
+ [mid saturated on one side only] * top) + 4 * 2^-24 * V (the decode's
own f32 roundings): a cell one side saturates and the other does not
switches the attribution of a whole overflow cell. `est` is the min over
rows of the post-fold wide value, so it is held to the largest
2 * (n + 1) * 2^-24 * V of the record's cells. Whole windows on the
tiered path hold the decoded CM tables to the window form of the same
bound, with N and F counted through the plain versions.

Whole windows otherwise: each f32 cell of the tables kernels 1, 4 and 7
write is held to 2 * (n + 1) * 2^-24 relative with n counted over the
window by folding unit masses through the plain versions; every other
table (HLL registers, histograms, the scalar totals) is exact, and the
heavy-hitter table (whose slot choices follow the Count-Min estimates)
shares at least 99 % of its identities.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

#: H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
U = 2.0 ** -24
BATCH = 16384
WINDOWS = 2
FOLDS_PER_WINDOW = 32
DECAY_FOLDS = 8
DECAY_FACTOR = 0.5
WARM_FOLDS = 3
CHAIN = 8
REPS = 50
#: the kernels redesigned for Hopper, with contract cases in the kernel
#: phase
REDESIGNED = ("topk_reduce", "signal_fold", "countmin_fold2",
              "countmin_tier2", "signal_fold_tiered", "hll_fold",
              "hll_fold_grid", "hll_fold_folds", "countmin_fold")
#: folds of each tiered shape of the C1 phase
C1_FOLDS = 4
#: threads of a warp, for the count of warp-aggregated atomics
WARP = 32
#: the empty kernel of the launch floor
FLOOR_SOURCE = "launch_floor.cu"
#: traces of one loop before `measure` fails the phase: a trace can come
#: back with no device events at all (seen about once a run on an H100,
#: torch 2.11), or with some missing (a kernel counted fewer times than the
#: loop ran it, seen as an in-place kernel's time below its restore's)
PROFILE_TRIES = 5
#: traces retried
PROFILE_RETRIED: list = []
#: compile-watch stats of every captured exporter of the run
WATCHED: list = []
#: the runs of a path: CUDA graphs replayed, the fold op by op with the
#: kernels, the fold op by op with the plain versions
MODES = ("captured", "eager", "plain")
#: the paths that fold wide (kernels 1, 2 and 4 and the HLL folds launch
#: on each ingest): the dense entry, the resident feed at one lane, the
#: lanes feed with its ladder, and the dense and compact rings
WIDE_PATHS = ("wide", "resident", "lanes", "dense_ring", "compact_ring")
#: the exporter of the resident path: one lane, no ladder (the bytes of
#: the one-lane `ResidentStagingRing`)
RESIDENT_KW = {"pack_threads": 1, "superbatch": (1,)}
#: the exporter of the lanes path: the reference agent's default on an
#: 8-CPU node (pack threads set, so the lanes do not follow this host)
LANES_KW = {"pack_threads": 8, "superbatch": (1, 2, 4)}
#: eviction sizes of the lanes path: the default flow cache's 5,000 rows
#: (CACHE_MAX_FLOWS) three times in four, else uniform over these bounds
EVICT_ROWS = 5000
EVICT_LARGE = (40_000, 70_000)
#: the window_thread phase: window length, the sink's seconds a report,
#: the seconds of feed, and the window (0-based) whose fold fails once
WINDOW_S = 0.5
SINK_SLEEP_S = 0.2
WT_SECONDS = 3.75  # ends mid-window: close has a partial window to publish
#: past WT_SECONDS the feed stops only when its last eviction went into the
#: open window and that window's deadline is at least this far: a window
#: closing on its own between the feed's end and `close` (the window thread
#: may be inside a sink call of SINK_SLEEP_S) would leave `close` an empty
#: window to publish
WT_MARGIN_S = 0.3
WT_FAIL_WINDOW = 2
#: the v6 share of each batch of the dense-ring pool: the last batch is a
#: burst past the compact feed's spill lane (B / 8 rows)
V6_SHARES = (0.05,) * 7 + (0.25,)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def _discard(report: dict) -> None:
    """The report sink of the phases that read `roll()`'s return value."""


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# --------------------------------------------------------------- helpers


def _clone(x):
    """A copy of every tensor in x (nested tuples, named or not). A tensor
    that x holds twice (a lane that several HLL folds read) is copied once
    and stays shared, as in the call it was captured from."""
    from netobserv_tpu_torch.sketch.capture import clone
    return clone(x)


def _tensors(x) -> list:
    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for v in x for t in _tensors(v)]
    return []


def _device_rows(prof) -> list[tuple[float, str, int]]:
    """(device us, name, count) of every device-side event of a trace."""
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue  # host-side ops: their kernels are listed themselves
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us, e.key, e.count))
    return sorted(rows, reverse=True)


def measure(fn, setup=None,
            reps: int = REPS) -> tuple[float | None, float]:
    """(event ms, device ms) per call of fn() over `reps` calls after a
    warm-up: CUDA events around the loop, then the same loop under
    torch.profiler for the device's own kernel and copy time, from a whole
    trace (every kernel counted a multiple of `reps` times) or the phase
    fails. With `setup` (which restores in-place inputs), setup alone is
    measured the same way and subtracted from both: the device difference
    must be positive, and a negative event difference is None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def loop(body) -> tuple[float, float]:
        for _ in range(5):
            body()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            body()
        end.record()
        torch.cuda.synchronize()
        for _ in range(PROFILE_TRIES):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    body()
                torch.cuda.synchronize()
            rows = _device_rows(prof)
            # every call runs the same kernels: a whole trace counts each
            # a multiple of reps times
            if rows and all(c % reps == 0 for _, _, c in rows):
                us = sum(r[0] for r in rows)
                return start.elapsed_time(end) / reps, us / 1e3 / reps
            PROFILE_RETRIED.append(1)
        raise PhaseError(f"no whole profiler trace (device events, every "
                         f"kernel a multiple of {reps} times) in "
                         f"{PROFILE_TRIES} traces")

    if setup is None:
        return loop(fn)
    both, alone = loop(lambda: (setup(), fn())), loop(setup)
    device = both[1] - alone[1]
    check(device > 0, f"the call's device time, {both[1]} ms with the "
          f"restore, is not above the restore's {alone[1]} ms")
    event = both[0] - alone[0]
    return (event if event >= 0 else None), device


def _exact(a, b) -> bool:
    """Bit equality of two tensors of any dtype (integer tiers compare as
    int64, floats by value)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        return bool(torch.equal(a, b))
    return bool(torch.equal(a.to(torch.int64), b.to(torch.int64)))


# ----------------------------------------------------------- the kernels


def kernel_specs():
    """Per kernel: its module, launch counter, wrapper and plain version,
    the path whose captured calls the kernel phase checks it on (with
    `derive`, the calls of another kernel of that path, each cut into this
    kernel's calls), its launches per fold on each main path, which
    arguments it updates in place (indices, or a function of the arguments
    giving the tensors; and their `state_tables` names, for the f32 sums),
    how to cut its inputs to n rows, whether its result is exact in any
    order, the Pallas kernel it replaces, and how a trace names its
    `__global__` (`trace`: demangled or mangled; the HLL entries share
    one, and kernel 6's C call counts by its fold kernel)."""
    from netobserv_tpu_torch.ops.kernels import (
        countmin_kernel, hll_kernel, signal_kernel, topk_kernel,
    )
    sig_tables = signal_kernel.SignalPlanes._fields
    flat_paths = {p: 1 for p in WIDE_PATHS}
    every_path = {"tiered": 2, **{p: 2 for p in WIDE_PATHS}}
    one_fold = lambda a, n: (a[0], *(t[:n] for t in a[1:]))  # noqa: E731
    return [
        dict(name="countmin_fold2", mod=countmin_kernel,
             kernel=countmin_kernel.KERNEL, path="wide", per_fold=flat_paths,
             trace=("cm_fold2_kernel<2>", "cm_fold2_kernelILi2E"),
             wrapper="update_two", plain="update_two_plain", inplace=(0, 1),
             tables=("cm_bytes", "cm_pkts"),
             rows=lambda a, n: (a[0], a[1], *(t[:n] for t in a[2:])),
             exact=False,
             replaces="netobserv_tpu/ops/pallas/countmin_kernel.py:81"),
        dict(name="topk_reduce", mod=topk_kernel, kernel=topk_kernel.KERNEL,
             path="wide", per_fold=every_path, trace=("topk_reduce_kernel",),
             wrapper="reduce",
             plain="reduce_plain", inplace=(),
             rows=lambda a, n: (*(t[:n] for t in a[:3]), a[3]), exact=True,
             replaces="netobserv_tpu/ops/pallas/topk_kernel.py:82"),
        # kernels 3 and 8 run on every path inside the folds launch below;
        # each is checked on its fold of the wide path's folds call
        dict(name="hll_fold", mod=hll_kernel, kernel=hll_kernel.KERNEL,
             path="wide", per_fold={}, trace=("hll_fold_kernel",),
             derive=("hll_fold_folds",
                     lambda a: [f for f in a[0] if len(f) == 4]),
             wrapper="update", plain="update_plain", inplace=(0,),
             rows=one_fold, exact=True,
             replaces="netobserv_tpu/ops/pallas/hll_kernel.py:70"),
        dict(name="signal_fold", mod=signal_kernel,
             kernel=signal_kernel.KERNEL, path="wide", per_fold=flat_paths,
             trace=("signal_fold_kernel",),
             wrapper="update", plain="update_plain", inplace=(0,),
             tables=sig_tables,
             rows=lambda a, n: (a[0], a[1][:, :n].contiguous(),
                                a[2][:, :n].contiguous()),
             exact=False,
             replaces="netobserv_tpu/ops/pallas/signal_kernel.py:164"),
        # kernel 5 (kernel 1's body with one value row) runs on a
        # width-sharded mesh's shard folds (`mesh_2x2`, two launches a
        # shard fold, off every one-device path): it is checked on the
        # wide path's kernel-1 inputs (table, h1, h2, bytes values)
        dict(name="countmin_fold", mod=countmin_kernel,
             kernel=countmin_kernel.KERNEL_ONE, path="wide", per_fold={},
             launch_path="mesh_2x2",
             trace=("cm_fold2_kernel<1>", "cm_fold2_kernelILi1E"),
             derive=("countmin_fold2", lambda a: [(a[0], a[2], a[3], a[4])]),
             wrapper="update", plain="update_plain", inplace=(0,),
             tables=("cm_bytes",),
             rows=lambda a, n: (a[0], *(t[:n] for t in a[1:])),
             exact=False,
             replaces="netobserv_tpu/ops/pallas/countmin_kernel.py:266"),
        dict(name="countmin_tier2", mod=countmin_kernel,
             kernel=countmin_kernel.KERNEL_TIER2, path="tiered",
             per_fold={"tiered": 1}, trace=("cm_tier2_kernel",),
             wrapper="update_two_tiered", plain="update_two_tiered_plain",
             inplace=(0, 1), tables=("cm_bytes", "cm_pkts"),
             rows=lambda a, n: (a[0], a[1], *(t[:n] for t in a[2:6]), a[6]),
             exact=False, chain=CHAIN,
             library_note="no single PyTorch call decodes, folds and "
                          "promotes the tiers",
             replaces="netobserv_tpu/ops/pallas/countmin_kernel.py:199"),
        dict(name="signal_fold_tiered", mod=signal_kernel,
             kernel=signal_kernel.KERNEL_TIERED, path="tiered",
             per_fold={"tiered": 1}, trace=("signal_fold_tiered_kernel",),
             wrapper="update_tiered", plain="update_tiered_plain",
             inplace=(0, 1), tables=sig_tables,
             rows=lambda a, n: (a[0], a[1], a[2][:, :n].contiguous(),
                                a[3][:, :n].contiguous(),
                                *(t[:n] for t in a[4:])),
             exact=False,
             library_note="no single PyTorch call max-folds a 6-bit "
                          "packed bank",
             replaces="netobserv_tpu/ops/pallas/signal_kernel.py:214"),
        dict(name="hll_fold_grid", mod=hll_kernel,
             kernel=hll_kernel.KERNEL_GRID, path="wide", per_fold={},
             trace=("hll_fold_kernel",),
             derive=("hll_fold_folds",
                     lambda a: [f for f in a[0] if len(f) == 5]),
             wrapper="update_per_dst", plain="update_per_dst_plain",
             inplace=(0,), rows=one_fold, exact=True,
             replaces="netobserv_tpu/ops/pallas/hll_kernel.py:81"),
        # the global-src HLL (not on the tiered path: kernel 7 folds its
        # packed bank) and both grids of a fold in one launch
        dict(name="hll_fold_folds", mod=hll_kernel,
             kernel=hll_kernel.KERNEL_FOLDS, path="wide",
             per_fold={"tiered": 1, **{p: 1 for p in WIDE_PATHS}},
             trace=("hll_fold_kernel",),
             wrapper="update_folds", plain="update_folds_plain",
             inplace=lambda a: [f[0] for f in a[0]],
             rows=lambda a, n: (tuple(one_fold(f, n) for f in a[0]),),
             exact=True,
             replaces="netobserv_tpu/ops/pallas/hll_kernel.py:40"),
    ]


def _unit_cells(spec, args):
    """The tables an f32-sum kernel adds into, zeroed, and the call's
    arguments with every non-zero value replaced by 1.0 (its plain version
    then counts each cell's adds)."""
    import torch
    a = _clone(args)
    name = spec["name"]
    if name == "countmin_fold2":
        for t in a[:2]:
            t.zero_()
        return a[:2], (*a[:4], (a[4] != 0).float(), (a[5] != 0).float())
    if name == "countmin_fold":
        a[0].zero_()
        return a[:1], (*a[:3], (a[3] != 0).float())
    if name == "countmin_tier2":
        pa, pb, h1, h2, va, vb, _ = a
        d, w = pa.base.shape
        wide = [torch.zeros((d, w), device=va.device) for _ in range(2)]
        return wide, (*wide, h1, h2, (va != 0).float(), (vb != 0).float())
    for t in a[0]:  # signal_fold, signal_fold_tiered: the eight tables
        t.zero_()
    idx, vals = (a[2], a[3]) if name == "signal_fold_tiered" else a[1:3]
    return a[0], (a[0], idx, (vals != 0).to(torch.float32))


def adds_per_cell(spec, args) -> list:
    """How many non-zero values each cell of the kernel's f32 tables (for
    kernel 6: of its wide view) takes in this call: the n of the bounds."""
    from netobserv_tpu_torch.ops.kernels import (
        countmin_kernel, signal_kernel,
    )
    tables, unit_args = _unit_cells(spec, args)
    if spec["name"] == "countmin_fold":
        countmin_kernel.update_plain(*unit_args)
    elif spec["name"] in ("countmin_fold2", "countmin_tier2"):
        countmin_kernel.update_two_plain(*unit_args)
    else:
        signal_kernel.update_plain(*unit_args)
    return _tensors(tuple(tables))


@contextlib.contextmanager
def plain_versions(specs, adds: dict | None = None,
                   touched: dict | None = None):
    """Route every wrapper to its plain version (on any device) for the
    duration: the main path then runs the kernels' PyTorch twins. With
    `adds`, every call of an f32-sum kernel also adds its per-cell count of
    non-zero values into adds[table name], and into touched[table name]
    one for every cell the call reached (the N and F of the bounds)."""
    saved = [(s["mod"], getattr(s["mod"], s["wrapper"])) for s in specs]
    for s in specs:
        plain = getattr(s["mod"], s["plain"])
        if adds is not None and "tables" in s:
            def plain(*args, _s=s, _fn=plain):
                for name, n in zip(_s["tables"], adds_per_cell(_s, args)):
                    adds[name] = adds[name] + n if name in adds else n
                    hit = (n > 0).float()
                    touched[name] = (touched[name] + hit if name in touched
                                     else hit)
                return _fn(*args)
        setattr(s["mod"], s["wrapper"], plain)
    try:
        yield
    finally:
        for (mod, fn), s in zip(saved, specs):
            setattr(mod, s["wrapper"], fn)


@contextlib.contextmanager
def recording(specs, calls: dict):
    """Record a clone of every wrapper call's arguments (before the call:
    in-place kernels mutate their tables)."""
    saved = [(s["mod"], getattr(s["mod"], s["wrapper"])) for s in specs]
    for s, (_, fn) in zip(specs, saved):
        def rec(*args, _fn=fn, _name=s["name"]):
            calls.setdefault(_name, []).append(_clone(args))
            return _fn(*args)
        setattr(s["mod"], s["wrapper"], rec)
    try:
        yield
    finally:
        for (mod, fn), s in zip(saved, specs):
            setattr(mod, s["wrapper"], fn)


def _inplace(spec, args) -> list:
    """The tensors a call of the kernel updates in place."""
    sel = spec["inplace"]
    if callable(sel):
        return sel(args)
    return _tensors(tuple(args[i] for i in sel))


def run_once(spec, fn_name: str, args):
    """Call the kernel (or plain version) on args in place; return the
    output tensors: the in-place tables, then whatever it returned."""
    out = getattr(spec["mod"], fn_name)(*args)
    return _inplace(spec, args) + _tensors(out)


def _expand(x, g: int):
    return x.repeat_interleave(g, dim=-1)


def tier_view_check(tk, tp, n_adds, n_folds, spec, unit: int) -> dict:
    """Hold one plane's tiers and decoded view, kernel side `tk` against
    plain side `tp` (base, mid, top), to the bound of the module docstring,
    given the per-cell adds `n_adds` and touching folds `n_folds` since the
    two sides were equal. Returns the worst reading beside its bound."""
    import torch
    from netobserv_tpu_torch.sketch import tiered
    mg, tg = spec.mid_group, spec.top_group
    tk, tp = tiered.TieredPlane(*tk), tiered.TieredPlane(*tp)
    bk, mk, ok = (x.to(torch.int64) for x in tk)
    bp, mp, op = (x.to(torch.int64) for x in tp)
    dk = tiered.decode_plane(tk, spec, unit).double()
    dp = tiered.decode_plane(tp, spec, unit).double()
    d, w = dk.shape
    v = torch.maximum(dk, dp) * (1 + 2.0 ** -8) + unit
    n_adds, n_folds = n_adds.double(), n_folds.double()
    a = 2 * (n_adds + n_folds) * U * v / unit + n_folds
    a_mid = 2 * a.reshape(d, w // mg, mg).sum(-1)
    a_top = 2 * a.reshape(d, w // tg, tg).sum(-1)
    for name, x, y, lim in (("base", bk, bp, a), ("mid", mk, mp, a_mid),
                            ("top", ok, op, a_top)):
        check(bool(((x - y).abs() <= lim).all()),
              f"tier {name}: kernel and plain differ past their bound")
    satb_k, satb_p = bk == tiered.BASE_MAX, bp == tiered.BASE_MAX
    satm_k, satm_p = mk == tiered.MID_MAX, mp == tiered.MID_MAX
    per_mid = tg // mg

    def mid_total(m, t):
        return (m + (m == tiered.MID_MAX) * _expand(t, per_mid)).double()

    sb = (satb_k | satb_p).double()
    fb = (satb_k ^ satb_p).double()
    sm = _expand((satm_k | satm_p).double(), mg)
    fm = _expand((satm_k ^ satm_p).double(), mg)
    lim = unit * (a + sb * (_expand(a_mid, mg) + sm * _expand(a_top, tg))
                  + fb * _expand(torch.maximum(mid_total(mk, ok),
                                               mid_total(mp, op)), mg)
                  + sb * fm * _expand(torch.maximum(ok, op).double(), tg)
                  ) + 4 * U * v
    diff = (dk - dp).abs()
    check(bool((diff <= lim).all()),
          "decoded view: kernel and plain differ past the tier bound")
    i = int(diff.argmax())
    return {"max_abs_diff": float(diff.reshape(-1)[i]),
            "bound_there": float(lim.reshape(-1)[i]),
            "value_there": float(dp.reshape(-1)[i]),
            "max_diff_over_bound": float((diff / lim).max()),
            "base_saturation_flips": int(fb.sum()),
            "mid_saturation_flips": int((satm_k ^ satm_p).sum())}


def compare_tier2(spec, args, kern, plain) -> dict:
    """Kernel 6 in the production regime: each plane's tiers and decoded
    view, and est, under the bound of the module docstring."""
    import torch
    from netobserv_tpu_torch.ops import hashing
    pa, pb, h1, h2, va, vb, tspec = args
    n_a, n_b = adds_per_cell(spec, args)
    out = {}
    for p, (name, n, unit) in enumerate((("cm_bytes", n_a,
                                          tspec.bytes_unit),
                                         ("cm_pkts", n_b, 1))):
        out[name] = tier_view_check(kern[3 * p:3 * p + 3],
                                    plain[3 * p:3 * p + 3], n,
                                    (n > 0).float(), tspec, unit)
    from netobserv_tpu_torch.sketch import tiered
    dmax = torch.maximum(
        tiered.decode_plane(tiered.TieredPlane(*kern[:3]), tspec,
                            tspec.bytes_unit),
        tiered.decode_plane(tiered.TieredPlane(*plain[:3]), tspec,
                            tspec.bytes_unit)).double()
    delta = 2 * (n_a.double() + 1) * U * (dmax * (1 + 2.0 ** -8)
                                          + tspec.bytes_unit)
    d, w = dmax.shape
    idx = hashing.row_indices(h1, h2, d, w)
    est_lim = torch.gather(delta, 1, idx).amax(dim=0)
    est_k, est_p = kern[6].double(), plain[6].double()
    diff = (est_k - est_p).abs()
    check(bool((diff <= est_lim).all()), "est: kernel and plain differ "
          "past 2*(n+1)*2^-24*V")
    i = int(diff.argmax())
    out["est"] = {"max_abs_diff": float(diff[i]),
                  "bound_there": float(est_lim[i]),
                  "max_rel_diff": float((diff / est_p.abs().clamp(
                      min=1e-30)).max())}
    return out


def compare(spec, args, regime: str) -> dict:
    import torch
    kern = run_once(spec, spec["wrapper"], _clone(args))
    plain = run_once(spec, spec["plain"], _clone(args))
    torch.cuda.synchronize()
    max_abs = max_rel = 0.0
    for k, p in zip(kern, plain):
        check(k.shape == p.shape and k.dtype == p.dtype,
              f"{spec['name']}: output shape/dtype differ")
        if not k.numel():
            continue  # kernel 6's est of an empty batch
        if k.dtype.is_floating_point:
            d = (k.double() - p.double()).abs()
            max_abs = max(max_abs, float(d.max()))
            mag = torch.maximum(k.double().abs(), p.double().abs())
            max_rel = max(max_rel, float((d / mag.clamp(min=1e-30)).max()))
        else:
            max_abs = max(max_abs, float((k.to(torch.int64)
                                          - p.to(torch.int64)).abs().max()))
    res = {"max_abs_err": max_abs, "max_rel_err": max_rel}
    if spec["name"] == "signal_fold_tiered":
        check(_exact(kern[8], plain[8]),
              f"signal_fold_tiered ({regime}): packed HLL bank differs")
    if spec["exact"] or regime == "integer":
        if regime == "integer" and not spec["exact"]:
            top = max(float(p.double().abs().max()) for p in plain
                      if p.numel())
            if spec["name"] == "countmin_tier2":
                from netobserv_tpu_torch.sketch import tiered
                tspec = args[6]
                top = max(float(tiered.decode_plane(
                    tiered.TieredPlane(*plain[3 * p:3 * p + 3]), tspec,
                    u).max()) for p, u in ((0, tspec.bytes_unit), (1, 1)))
            check(top < 2 ** 24, f"{spec['name']}: integer regime input "
                  f"reaches {top} >= 2^24")
        check(all(_exact(k, p) for k, p in zip(kern, plain)),
              f"{spec['name']} ({regime}): not bit-exact, max abs err "
              f"{max_abs}")
        res["bound"] = "bit-exact"
    elif spec["name"] == "countmin_tier2":
        res.update(bound="tier bound (module docstring)",
                   worst=compare_tier2(spec, args, kern, plain))
    else:
        adds = adds_per_cell(spec, args)
        for k, p, n in zip(kern, plain, adds):
            lim = 2 * (n.double() + 1) * U * torch.maximum(
                k.double().abs(), p.double().abs())
            check(bool(((k.double() - p.double()).abs() <= lim).all()),
                  f"{spec['name']} ({regime}): outside the 2*(n+1)*2^-24 "
                  "bound")
        res["bound"] = "2*(n_adds+1)*2^-24 relative per cell"
    return res


def integer_inputs(spec, args):
    """The call's indices on fresh (zero) tables with each non-zero value v
    replaced by the integer v mod 251 + 1: every per-cell sum then stays
    below 16384 * 251 < 2^24, where add order cannot change a bit, while
    the same cells take the same number of atomics as on the main path."""
    import torch
    a = _clone(args)
    for t in _inplace(spec, a):
        t.zero_()

    def small(v):
        return torch.where(v != 0, torch.remainder(v, 251.0).floor() + 1,
                           0.0)

    name = spec["name"]
    if name == "countmin_fold2":
        return (*a[:4], small(a[4]), small(a[5]))
    if name == "countmin_fold":
        return (*a[:3], small(a[3]))
    if name == "countmin_tier2":
        return (*a[:4], small(a[4]), small(a[5]), a[6])
    if name == "signal_fold":
        return (a[0], a[1], small(a[2]))
    if name == "signal_fold_tiered":
        return (a[0], a[1], a[2], small(a[3]), *a[4:])
    return a


def integer_chain(spec, args) -> list[dict]:
    """Kernel 6 in the integer regime over CHAIN folds of the same call
    from fresh tiers, the kernel and the plain version each on its own
    tiers, bit-exact after every fold; the last fold must have reached the
    top tier."""
    from netobserv_tpu_torch.sketch import tiered
    a = integer_inputs(spec, args)
    ak, ap = _clone(a), _clone(a)
    out = []
    for fold in range(spec["chain"]):
        kern = run_once(spec, spec["wrapper"], ak)
        plain = run_once(spec, spec["plain"], ap)
        top = max(float(tiered.decode_plane(
            tiered.TieredPlane(*plain[3 * p:3 * p + 3]), a[6], u).max())
            for p, u in ((0, a[6].bytes_unit), (1, 1)))
        check(top < 2 ** 24, f"integer chain reaches {top} >= 2^24")
        check(all(_exact(k, p) for k, p in zip(kern, plain)),
              f"{spec['name']} (integer chain fold {fold}): not bit-exact")
        out.append({"fold": fold, "max_decoded": top})
    tops = sum(int((p.top.to("cpu").numpy() > 0).sum()) for p in ak[:2])
    check(tops > 0, "integer chain never reached the top tier")
    out[-1]["top_cells_active"] = tops
    return out


def timing(spec, args):
    """`measure` of the kernel and of its plain version on the main path's
    inputs; in-place tables are restored from the captured state before
    every launch."""
    work = _clone(args)
    src, dst = _inplace(spec, args), _inplace(spec, work)

    def restore():
        for d, s in zip(dst, src):
            d.copy_(s)

    setup = restore if spec["inplace"] else None
    out = []
    for fn_name in (spec["wrapper"], spec["plain"]):
        fn = getattr(spec["mod"], fn_name)
        out.append(measure(lambda: fn(*work), setup))
    return out[0], out[1]


def library_call(spec, args):
    """One PyTorch call computing the same function (a yardstick only; the
    port never calls it), with its index/value prep done outside it; None
    where there is none."""
    import torch
    from netobserv_tpu_torch.ops import hashing
    from netobserv_tpu_torch.ops.kernels import hll_kernel
    name = spec["name"]
    if "library_note" in spec:
        return None
    if name == "countmin_fold2":
        ca, cb, h1, h2, va, vb = args
        d, w = ca.shape
        idx = hashing.row_indices(h1, h2, d, w)
        cell = (idx + torch.arange(d, device=idx.device)[:, None] * w
                ).reshape(-1)
        cell = torch.cat([cell, cell + d * w])
        vals = torch.cat([va.expand(d, -1).reshape(-1),
                          vb.expand(d, -1).reshape(-1)])
        table = torch.stack([ca, cb]).reshape(-1)
        return lambda: table.index_put_((cell,), vals, accumulate=True)
    if name == "topk_reduce":
        # the two maxima in one scatter (the winner row needs a second)
        mslot, target, est, k = args
        cell = torch.cat([mslot, target + k + 1])
        vals = torch.cat([est, est])
        table = torch.full((2 * (k + 1),), -1.0, device=est.device)
        return lambda: table.scatter_reduce_(0, cell, vals, "amax")
    if name == "countmin_fold":
        counts, h1, h2, vals = args
        d, w = counts.shape
        idx = hashing.row_indices(h1, h2, d, w)
        cell = (idx + torch.arange(d, device=idx.device)[:, None] * w
                ).reshape(-1)
        flat_vals = vals.expand(d, -1).reshape(-1)
        table = counts.clone().reshape(-1)
        return lambda: table.index_add_(0, cell, flat_vals)
    if name.startswith("hll_fold"):
        # the folds' register files end to end, one scatter over them all
        cells, ranks, tables = [], [], []
        for f in _hll_folds(name, args):
            cells.append(_hll_cells(f) + sum(t.numel() for t in tables))
            ranks.append(torch.where(f[-1], hll_kernel.rank(f[-2]), 0))
            tables.append(f[0].reshape(-1))
        cell, rank = torch.cat(cells), torch.cat(ranks)
        table = torch.cat(tables)
        return lambda: table.scatter_reduce_(0, cell, rank, "amax")
    planes, idx, vals = args
    from netobserv_tpu_torch.ops.kernels.signal_kernel import FAMILY
    sizes = [p.shape[0] for p in planes]
    offs = [sum(sizes[:j]) for j in range(len(sizes))]
    cell = torch.cat([idx[FAMILY[j]] + offs[j] for j in range(len(sizes))])
    table = torch.cat([p.clone() for p in planes])
    flat = vals.reshape(-1)
    return lambda: table.index_add_(0, cell, flat)


def _hll_folds(name: str, args) -> tuple:
    """The folds of a call of kernel 3, kernel 8 or the folds launch."""
    return args[0] if name == "hll_fold_folds" else (args,)


def _hll_cells(fold):
    """Flat cell of every row of an HLL fold: h1 & (m-1) for kernel 3's
    (regs, h1, h2, valid), (dst_h & (D-1)) * m + (src_h1 & (m-1)) for
    kernel 8's (regs, dst_h, src_h1, src_h2, valid)."""
    if len(fold) == 4:
        return fold[1] & (fold[0].shape[0] - 1)
    dbuckets, m = fold[0].shape
    return (fold[1] & (dbuckets - 1)) * m + (fold[2] & (m - 1))


def _sector_bytes(elems, elem_size: int = 4) -> int:
    """Bytes of the distinct 32-byte sectors that the given element indices
    of one array reach, read once and written once."""
    import torch
    return 2 * 32 * int(torch.unique(elems // (32 // elem_size)).numel())


def _signal_bytes_ops(planes, idx, vals) -> tuple[int, int]:
    from netobserv_tpu_torch.ops.kernels.signal_kernel import FAMILY
    nbytes = sum(t.numel() * t.element_size() for t in (idx, vals)) + sum(
        _sector_bytes(idx[FAMILY[j]][vals[j] != 0])
        for j in range(len(planes)))
    return nbytes, int((vals != 0).sum())


def _cm_atomics(cells, values, size: int) -> dict:
    """The atomics of kernels 1 and 5 as their design makes them, for the
    cells r * W + col [d, n] of a call and each plane's values [n]: thread
    t = r * n + b sits in warp t // 32, and the leader of each distinct
    (warp, cell) with a non-zero value makes one atomic a plane. Beside
    them, one per (record, row) of a non-zero value, as a design without
    warp aggregation makes them."""
    import torch
    d, n = cells.shape
    warp = (torch.arange(d, device=cells.device)[:, None] * n
            + torch.arange(n, device=cells.device)) // WARP
    hits = [cells[:, v != 0].reshape(-1) for v in values]
    groups = [torch.unique(warp[:, v != 0] * size + cells[:, v != 0]) % size
              for v in values]

    def most(cs):
        return max((int(torch.bincount(c).max()) for c in cs if c.numel()),
                   default=0)

    return {"atomics": sum(g.numel() for g in groups),
            "max_atomics_one_address": most(groups),
            "atomics_one_per_row": sum(c.numel() for c in hits),
            "max_atomics_one_address_one_per_row": most(hits)}


def bound_of(spec, args) -> dict:
    """Least time the card could take for this call: the larger of the
    bytes it must move over HBM bandwidth and its f32 operations over the
    f32 peak (see the module docstring), with the counts behind them."""
    import torch
    from netobserv_tpu_torch.ops import hashing
    from netobserv_tpu_torch.ops.kernels import countmin_kernel

    def read(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    name = spec["name"]
    extra = {}
    if name in ("countmin_fold2", "countmin_fold"):
        # kernel 1 (ca, cb, h1, h2, va, vb) or kernel 5 (counts, h1, h2, vals)
        planes = 2 if name == "countmin_fold2" else 1
        h1, h2 = args[planes:planes + 2]
        values = args[planes + 2:]
        d, w = args[0].shape
        cells = (hashing.row_indices(h1, h2, d, w)
                 + torch.arange(d, device=h1.device)[:, None] * w)
        hits = [cells[:, v != 0].reshape(-1) for v in values]
        nbytes = read(args[planes:]) + sum(_sector_bytes(c) for c in hits)
        ops = sum(c.numel() for c in hits)  # one f32 add per (record, row)
        extra = _cm_atomics(cells, values, d * w)
    elif name == "countmin_tier2":
        pa, pb, h1, h2, va, vb, tspec = args
        d, w = pa.base.shape
        cols = hashing.row_indices(h1, h2, d, w)
        rows = torch.arange(d, device=h1.device)[:, None].expand_as(cols)
        nbytes = read((h1, h2, va, vb)) + 4 * h1.numel()  # inputs, est
        ops = 0
        for plane, v in ((pa, va), (pb, vb)):
            c, r = cols[:, v != 0].reshape(-1), rows[:, v != 0].reshape(-1)
            ops += c.numel()
            for arr, g in ((plane.base, 1), (plane.mid, tspec.mid_group),
                           (plane.top, tspec.top_group)):
                nbytes += _sector_bytes(r * (w // g) + c // g,
                                        arr.element_size())
        tiles = torch.bincount((cols // countmin_kernel.TILE_W).reshape(-1))
        extra = {"adds": ops, "max_adds_one_cell": max(
            int(torch.bincount((cols + rows * w)[:, v != 0].reshape(-1)
                               ).max()) for v in (va, vb)),
            "bin_entries": cols.numel(),
            "max_bin_entries": int(tiles.max()),
            "median_bin_entries": float(tiles.float().median())}
    elif name == "topk_reduce":
        mslot, target, est, k = args
        nbytes = read((mslot, target, est)) + 3 * k * 4  # fresh outputs
        ops = 3 * est.numel()  # two maxima and a minimum per row
    elif name.startswith("hll_fold"):
        # each lane once, though several folds read it; each register file's
        # sectors that its valid rows reach
        folds = _hll_folds(name, args)
        lanes = {t.data_ptr(): t for f in folds for t in f[1:]}
        nbytes = read(lanes.values()) + sum(
            _sector_bytes(_hll_cells(f)[f[-1]]) for f in folds)
        ops = sum(int(f[-1].sum()) for f in folds)
        # the kernel's warps as it makes them (row b of a fold in warp
        # b // 32): one atomic per distinct (warp, cell) of valid rows
        groups = [torch.unique(
            (torch.arange(f[-1].numel(), device=f[-1].device) // WARP
             * f[0].numel() + _hll_cells(f))[f[-1]]) % f[0].numel()
            for f in folds]
        extra = {"atomics": sum(g.numel() for g in groups),
                 "max_atomics_one_address": max(
                     (int(torch.bincount(g).max()) for g in groups
                      if g.numel()), default=0),
                 "atomics_one_per_row": ops}
    elif name == "signal_fold_tiered":
        planes, packed, idx, vals, h1, h2, valid = args
        nbytes, ops = _signal_bytes_ops(planes, idx, vals)
        m_hll = packed.shape[0] // 3 * 4
        first = 3 * ((h1 & (m_hll - 1))[valid] // 4)  # first byte of triple
        nbytes += read((h1, h2, valid)) + _sector_bytes(
            torch.cat([first, first + 2]), 1)
        ops += int(valid.sum())
    else:
        nbytes, ops = _signal_bytes_ops(*args)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": by,
            "bound_bytes": nbytes, "bound_ops": ops, **extra}


def uniform_variant(spec, args):
    """The same call with the hot key spread out: random hashes (kernels 1,
    3, 5, 6 and 8, and the HLL folds launch), random slots (kernel 2) or
    random indices in every table (kernel 4; kernel 7 also random HLL
    registers), to price same-address atomics."""
    import torch
    if spec["name"].startswith("hll_fold"):
        # every hash lane random (a lane several folds read stays shared)
        folds = _hll_folds(spec["name"], args)
        g = torch.Generator(device=folds[0][-1].device).manual_seed(1)
        rand: dict = {}

        def spread(f):
            for t in f[1:-1]:
                if t.data_ptr() not in rand:
                    rand[t.data_ptr()] = torch.randint(
                        0, 2**32, t.shape, generator=g, device=t.device,
                        dtype=torch.int64)
            return (f[0], *(rand[t.data_ptr()] for t in f[1:-1]), f[-1])

        folds = tuple(spread(f) for f in folds)
        return (folds,) if spec["name"] == "hll_fold_folds" else folds[0]
    if spec["name"] in ("signal_fold", "signal_fold_tiered"):
        tiered = spec["name"] == "signal_fold_tiered"
        planes, idx = args[0], args[2 if tiered else 1]
        g = torch.Generator(device=idx.device).manual_seed(1)
        sizes = [planes.ddos_rate.shape[0]] * 3 + [
            planes.dscp_bytes.shape[0], planes.drop_causes.shape[0]]
        uni = torch.stack([torch.randint(0, size, idx.shape[1:], generator=g,
                                         device=idx.device)
                           for size in sizes])
        if not tiered:
            return (planes, uni, args[2])
        h1 = torch.randint(0, 2**32, idx.shape[1:], generator=g,
                           device=idx.device, dtype=torch.int64)
        return (planes, args[1], uni, args[3], h1, *args[5:])
    if spec["name"] in ("countmin_fold2", "countmin_tier2", "countmin_fold"):
        lanes = 1 if spec["name"] == "countmin_fold" else 2  # tables first
        h1 = args[lanes]
        g = torch.Generator(device=h1.device).manual_seed(1)
        r = lambda: torch.randint(0, 2**32, h1.shape, generator=g,  # noqa
                                  device=h1.device, dtype=torch.int64)
        return (*args[:lanes], r(), r() | 1, *args[lanes + 2:])
    mslot, target, est, k = args
    g = torch.Generator(device=mslot.device).manual_seed(1)
    r = lambda: torch.randint(0, k + 1, mslot.shape, generator=g,  # noqa
                              device=mslot.device, dtype=torch.int64)
    return (r(), r(), est, k)


def contract_cases(spec, args) -> list[dict]:
    """The redesigned kernels against their plain versions, bit-exact, on
    the seeded contract cases of `ops/kernels/cases.py` (the CPU tests hold
    the plain versions against the JAX package on the same cases): kernel 2
    at K = 128, the path's K and a K of three slot tiles, kernel 4 at the
    path's m onto tables of small integers, kernel 7 the same with the
    path's bank and one of 64 registers (one tile of 16 triples), the
    last case at m = 16,384, kernels 1, 5 and 6 at a width of one tile and
    the path's width (kernels 1 and 5 onto tables of small integers, kernel
    5 with `va` as its one value row, kernel 6 onto `cases.tier_planes`
    under the path's TierSpec), kernels 3 and 8 and the folds launch at the
    path's geometry of each fold and at a small one (64 registers, a 32 x
    16 grid), from the cases' pre-fold registers."""
    import numpy as np
    import torch
    from netobserv_tpu_torch.ops.kernels import (
        cases, countmin_kernel, signal_kernel, topk_kernel,
    )
    from netobserv_tpu_torch.sketch import tiered
    if spec["name"].startswith("hll_fold"):
        return hll_contract_cases(spec, args)
    dev = args[2].device  # the path's device: est of kernel 2, h1 or vals
    out = []
    if spec["name"].startswith("countmin"):
        tier = spec["name"] == "countmin_tier2"
        planes = 1 if spec["name"] == "countmin_fold" else 2
        d, w = args[0].base.shape if tier else args[0].shape
        rng = np.random.default_rng(3)
        for width in (countmin_kernel.TILE_W, w):
            for name, c in cases.countmin_cases(width):
                batch = [torch.from_numpy(c[f]).to(dev)
                         for f in ("h1", "h2", "va", "vb")[:2 + planes]]
                if tier:
                    tspec = args[6]
                    a = (*(tiered.TieredPlane(*(torch.from_numpy(x).to(dev)
                                                for x in p))
                           for p in cases.tier_planes(
                               d, width, tspec.mid_group, tspec.top_group)),
                         *batch, tspec)
                else:
                    a = (*(torch.from_numpy(rng.integers(0, 50, (
                        d, width)).astype(np.float32)).to(dev)
                        for _ in range(planes)), *batch)
                r = compare(spec, a, "integer")
                out.append({"case": name, "w": width, "rows": len(c["va"]),
                            "max_abs_err": r["max_abs_err"]})
        return out
    if spec["name"] == "topk_reduce":
        # the path's K, a small one, and one of three tiles
        for k in (128, args[3], 2 * topk_kernel.TILE + 5):
            for name, c in cases.topk_cases(k):
                a = (*(torch.from_numpy(c[f]).to(dev)
                       for f in ("mslot", "target", "est")), k)
                r = compare(spec, a, "integer")
                out.append({"case": name, "k": k, "rows": len(c["est"]),
                            "max_abs_err": r["max_abs_err"]})
        return out
    m = args[0].ddos_rate.shape[0]
    rng = np.random.default_rng(3)
    if spec["name"] == "signal_fold_tiered":
        for m_hll in (args[1].shape[0] // 3 * 4, 64):
            for name, c in cases.tiered_signal_cases(m, m_hll):
                planes = signal_kernel.SignalPlanes(*(
                    torch.from_numpy(rng.integers(0, 50, size).astype(
                        np.float32)).to(dev)
                    for size in (c["m"],) * 6 + tuple(
                        p.shape[0] for p in args[0][6:])))
                packed = tiered.pack_hll(torch.from_numpy(c["regs"]).to(dev))
                a = (planes, packed, *(torch.from_numpy(c[f]).to(dev) for f
                                       in ("idx", "vals", "h1", "h2",
                                           "valid")))
                r = compare(spec, a, "integer")
                out.append({"case": name, "m": c["m"], "m_hll": m_hll,
                            "rows": c["vals"].shape[1],
                            "max_abs_err": r["max_abs_err"]})
        return out
    for name, c in cases.signal_cases(m):
        planes = signal_kernel.SignalPlanes(*(
            torch.from_numpy(rng.integers(0, 50, p.shape[0]).astype(
                np.float32)).to(dev) for p in args[0]))
        a = (planes, torch.from_numpy(c["idx"]).to(dev),
             torch.from_numpy(c["vals"]).to(dev))
        r = compare(spec, a, "integer")
        out.append({"case": name, "m": m, "rows": c["vals"].shape[1],
                    "max_abs_err": r["max_abs_err"]})
    return out


def hll_contract_cases(spec, args) -> list[dict]:
    """contract_cases of kernels 3 and 8 and the folds launch: each fold
    of the call takes the case of one name from `cases.hll_fold_cases` at
    its geometry (seeded by its place), so a folds call runs its folds on
    one batch size in one launch."""
    import torch
    from netobserv_tpu_torch.ops.kernels import cases
    folds = _hll_folds(spec["name"], args)
    dev = folds[0][0].device
    path = [(1, f[0].shape[0]) if len(f) == 4 else tuple(f[0].shape)
            for f in folds]
    small = [(1, 64) if d == 1 else (32, 16) for d, _ in path]
    out = []
    for geometry in (path, small):
        per_fold = [cases.hll_fold_cases(d, m, seed)
                    for seed, (d, m) in enumerate(geometry)]
        for named in zip(*per_fold):
            name = named[0][0]
            fs = []
            for (_, c), f in zip(named, folds):
                t = {k: torch.from_numpy(v).to(dev) for k, v in c.items()}
                fs.append((t["regs"].reshape(-1), t["h1"], t["h2"],
                           t["valid"]) if len(f) == 4 else
                          (t["regs"], t["dst"], t["h1"], t["h2"],
                           t["valid"]))
            a = (tuple(fs),) if spec["name"] == "hll_fold_folds" else fs[0]
            r = compare(spec, a, "integer")
            out.append({"case": name, "geometry": geometry,
                        "rows": len(named[0][1]["valid"]),
                        "max_abs_err": r["max_abs_err"]})
    return out


def launch_shapes(spec, args) -> tuple[list, int]:
    """The grids a call of the kernel launches at these arguments (the
    wrappers' `launch_shape*`), and its cluster barriers (kernel 2: two
    per slot tile)."""
    from netobserv_tpu_torch.ops.kernels import (
        countmin_kernel, hll_kernel, signal_kernel, topk_kernel,
    )
    name = spec["name"]
    if name == "topk_reduce":
        return [topk_kernel.launch_shape(args[3])], 2
    if name == "signal_fold_tiered":
        return [signal_kernel.launch_shape_tiered(args[3].shape[1],
                                                  args[1].shape[0])], 0
    if name == "signal_fold":
        return [signal_kernel.launch_shape(args[2].shape[1])], 0
    if name == "countmin_fold2":
        return [countmin_kernel.launch_shape(args[2].shape[0],
                                             args[0].shape[0])], 0
    if name == "countmin_fold":
        return [countmin_kernel.launch_shape(args[1].shape[0],
                                             args[0].shape[0])], 0
    if name == "countmin_tier2":
        d, w = args[0].base.shape
        return countmin_kernel.launch_shapes_tier2(
            args[2].shape[0], d, w, args[6].mid_group, args[6].top_group), 0
    folds = _hll_folds(name, args)  # kernels 3 and 8, the folds launch
    return [hll_kernel.launch_shape(folds[0][1].shape[0], len(folds))], 0


def launch_floor(spec, args) -> dict:
    """Device and event time of an empty kernel launched at each of the
    kernel's own grids, clusters, blocks and shared memory
    (csrc/launch_floor.cu), summed over its launches, alone and, for
    kernel 2, with the two cluster barriers of its one slot tile: the least
    a call of that shape takes, beside the byte bound."""
    import torch
    from netobserv_tpu_torch.ops.kernels._build import CudaKernel
    shapes, barriers = launch_shapes(spec, args)
    floor = CudaKernel(FLOOR_SOURCE, "launch_floor", n_ptrs=0, n_ints=5)
    dev = torch.device("cuda")
    out = {"shapes": [s._asdict() for s in shapes]}
    for syncs in sorted({0, barriers}):
        times = [measure(lambda s=s: floor.launch([], [*s, syncs], dev))
                 for s in shapes]
        out[f"syncs_{syncs}"] = {"device_ms": sum(dv for _, dv in times),
                                 "event_ms": sum(ev for ev, _ in times)}
    return out


# --------------------------------------------------------------- phases


def phase_device() -> dict:
    import torch
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    # FLP_CONFIG is YAML: direct-flp parses it with PyYAML
    try:
        import yaml
        have_yaml = f"yaml {yaml.__version__}"
    except ImportError as exc:
        have_yaml = f"yaml: ImportError: {exc}"
    print(have_yaml, flush=True)
    return {"phase": "device", "kind": name, "nvidia_smi": line,
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "yaml": have_yaml}


def phase_build(specs) -> dict:
    """Every kernel library (one nvcc each, all at once), then the native
    packer's (g++)."""
    from netobserv_tpu_torch.datapath import flowpack
    from netobserv_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    secs = _build.build(sorted({s["kernel"].source for s in specs}
                               | {FLOOR_SOURCE}))
    t1 = time.perf_counter()
    flowpack.native_lib()
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "per_source_seconds": secs,
            "packer_seconds": time.perf_counter() - t1}


def tiered_cfg():
    from netobserv_tpu_torch.sketch import state as sk
    from netobserv_tpu_torch.sketch.tiered import TierSpec
    return sk.SketchConfig(tiered=TierSpec())


def capture_main_path_inputs(specs, dense, cfg) -> dict:
    """Warm a state under `cfg` with WARM_FOLDS folds (plain versions),
    then record every wrapper call of one more fold: the exact inputs the
    path hands each kernel, production-regime tables included."""
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    # eager: a replayed graph calls no wrapper
    exp = TorchSketchExporter(cfg, batch_size=BATCH, device="cuda",
                              sink=_discard, capture=False)
    calls: dict = {}
    with plain_versions(specs):
        for i in range(WARM_FOLDS):
            exp.fold_dense(dense[i % len(dense)])
        with recording(specs, calls):
            exp.fold_dense(dense[WARM_FOLDS % len(dense)])
    exp.close()
    return calls


def _calls_of(spec, calls: dict) -> list:
    """A kernel's recorded calls: its own, or (`derive`) those cut from
    another kernel's."""
    if "derive" in spec:
        src, cut = spec["derive"]
        return [c for a in calls.get(src, []) for c in cut(a)]
    return calls.get(spec["name"], [])


def phase_kernels(specs, calls) -> list[dict]:
    import torch
    results = []
    for s in specs:
        recs = _calls_of(s, calls[s["path"]])
        check(len(recs) >= 1, f"{s['name']}: the main path never called it")
        case = {"phase": "kernel", "name": s["name"], "path": s["path"],
                "calls_per_fold": len(recs), "cases": []}
        s["kernel"].launches = 0
        errs = []
        for ci, args in enumerate(recs):
            for n in (BATCH, BATCH - 1):
                a = s["rows"](args, n)
                for regime, aa in (("production", a),
                                   ("integer", integer_inputs(s, a))):
                    r = compare(s, aa, regime)
                    r.update(call=ci, rows=n, regime=regime)
                    case["cases"].append(r)
                    errs.append(r["max_abs_err"])
        args = recs[0]
        if "chain" in s:
            case["integer_chain"] = integer_chain(s, args)
        (k_ms, dev_k_ms), (p_ms, dev_p_ms) = timing(s, args)
        lib = library_call(s, args)
        lib_ms, dev_lib_ms = measure(lib) if lib else (None, None)
        case.update(kernel_ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                    device_kernel_ms=dev_k_ms, device_plain_ms=dev_p_ms,
                    device_library_ms=dev_lib_ms, **bound_of(s, args),
                    max_abs_err=max(errs),
                    max_rel_err=max(c["max_rel_err"] for c in case["cases"]))
        if "library_note" in s:
            case["library_note"] = s["library_note"]
        if s["name"] in REDESIGNED:
            uni = uniform_variant(s, args)
            case["device_kernel_ms_uniform_keys"] = timing(s, uni)[0][1]
            case["contract_cases"] = contract_cases(s, args)
        case["launch_floor"] = launch_floor(s, args)
        torch.cuda.synchronize()
        case["kernel_phase_launches"] = s["kernel"].launches
        check(case["kernel_phase_launches"] > 0,
              f"{s['name']}: the kernel phase never launched it")
        emit(case)
        results.append(case)
    return results


def hot_key_rows(pool) -> list[int]:
    import numpy as np
    return [int(np.bincount(ranks).max()) for _, ranks in pool]


def dense_feeder(dense):
    """Fold pool batch bi through the dense feed."""
    return lambda exp, bi: exp.fold_dense(dense[bi])


def event_feeder(events):
    """Fold pool batch bi through the exporter's feed of events."""
    return lambda exp, bi: exp.fold_events(events[bi][0], **events[bi][1])


def _concat(parts):
    """One (events, feature lanes) of the parts' rows, in order."""
    import numpy as np
    return (np.concatenate([e for e, _ in parts]),
            {k: np.concatenate([f[k] for _, f in parts])
             for k in parts[0][1]})


class LaneFeeder:
    """The lanes path's traffic: a window is the pool batches it names
    (FOLDS_PER_WINDOW of them, as on every path), delivered as evictions
    (`export_evicted`) of seeded sizes: EVICT_ROWS three times in four,
    else uniform over EVICT_LARGE, the last one cut at the window's end.
    The call for a window's i-th batch delivers every eviction that ends
    within its first i + 1 batches; a window is whole batches, so the
    pending buffer is empty after its last call. Every exporter gets
    the same evictions (the sizes come from `numpy.random.default_rng(1)`,
    drawn anew for each exporter)."""

    def __init__(self, events):
        import numpy as np
        n = len(events)
        # both windows fold batches 0..n-1 in turn: one stream serves them
        self.stream = _concat([events[i % n]
                               for i in range(FOLDS_PER_WINDOW)])
        self.n_batches = n
        self._exp = None
        self._np = np

    def _cuts(self) -> list[int]:
        """The ends of one window's evictions in the stream."""
        total, ends = FOLDS_PER_WINDOW * BATCH, []
        end = 0
        while end < total:
            if self._rng.random() < 0.75:
                size = EVICT_ROWS
            else:
                size = int(self._rng.integers(*EVICT_LARGE))
            end = min(end + size, total)
            ends.append(end)
        return ends

    def __call__(self, exp, bi: int) -> None:
        from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
        if exp is not self._exp:
            self._exp, self._calls = exp, 0
            self._rng = self._np.random.default_rng(1)
            self.sizes = []
        i = self._calls % FOLDS_PER_WINDOW
        if i == 0:
            self._ends, self._start = self._cuts(), 0
            self.sizes += [b - a for a, b in zip([0, *self._ends],
                                                 self._ends)]
        self._calls += 1
        ev, lanes = self.stream
        upto = (i + 1) * BATCH
        while self._ends and self._ends[0] <= upto:
            lo, hi = self._start, self._ends.pop(0)
            exp.export_evicted(EvictedFlows(
                ev[lo:hi], **{k: v[lo:hi] for k, v in lanes.items()}))
            self._start = hi


class SuperbatchFeeder:
    """Folds of k pool batches at once (one eviction of k * BATCH rows,
    which the lanes feed dispatches as one k-superbatch): call j folds
    batches jk .. jk + k - 1 (mod the pool)."""

    def __init__(self, events, k: int):
        n = len(events)
        self.k = k
        self.parts = [_concat([events[(j * k + i) % n] for i in range(k)])
                      for j in range(n)]

    def __call__(self, exp, bi: int) -> None:
        ev, lanes = self.parts[bi % len(self.parts)]
        exp.fold_events(ev, **lanes)


@contextlib.contextmanager
def counting_plains(specs, counts: dict):
    """Count every call of a plain version (by the wrappers or anyone) in
    counts[kernel name] for the duration."""
    saved = [(s["mod"], s["plain"], getattr(s["mod"], s["plain"]))
             for s in specs]
    for s, (mod, attr, fn) in zip(specs, saved):
        def counted(*args, _fn=fn, _name=s["name"]):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*args)
        setattr(mod, attr, counted)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _pack_seconds(exp) -> float:
    """The host seconds the exporter's ring spent packing so far (0 before
    its first fold of events makes the ring)."""
    return exp.ring.pack_seconds if exp.ring is not None else 0.0


def _watch_stats(exp) -> list:
    """The compile watch's snapshot, taken while the exporter lives: the
    entries of its captured folds, which must stand in it. Kept in
    WATCHED for the `retrace_watch` line."""
    from netobserv_tpu_torch.utils import retrace
    snap = retrace.snapshot()
    mine = [c.stats() for c in exp.captures]
    check(all(m in snap for m in mine),
          f"captured folds {mine} missing from the watch's snapshot")
    WATCHED.extend(mine)
    return mine


def _window(exp, feed, n_batches: int, first: int, n_folds: int,
            adds: dict, touched: dict) -> dict:
    """Fold n_folds pool batches from `first` (mod n_batches) through
    `feed`, then read the pre-roll tables (and tier arrays), roll, and time
    each step; for the resident feed also the ring's pack time."""
    import torch
    from netobserv_tpu_torch.sketch import tiered
    adds.clear()
    touched.clear()
    torch.cuda.synchronize()
    pack0 = _pack_seconds(exp)
    t0 = time.perf_counter()
    batches = []
    for i in range(n_folds):
        bi = (first + i) % n_batches
        batches.append(bi)
        feed(exp, bi)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    t1 = time.perf_counter()
    tables = exp.state_tables()
    t2 = time.perf_counter()
    tiers = (_clone(exp.state.tables)
             if isinstance(exp.state, tiered.TieredState) else None)
    report = exp.roll()
    return dict(feed=batches, seconds=secs, tables=tables, tiers=tiers,
                report=report, tables_seconds=t2 - t1,
                roll_seconds=time.perf_counter() - t2,
                pack_seconds=_pack_seconds(exp) - pack0,
                adds={k: v.cpu().numpy() for k, v in adds.items()},
                touched={k: v.cpu().numpy() for k, v in touched.items()})


def run_windows(feed, n_batches: int, mode: str, specs, cfg,
                decay_window: bool = False, ring: bool = False,
                exp_kw: dict | None = None):
    """Fold WINDOWS x FOLDS_PER_WINDOW pool batches through `feed` into an
    exporter under `cfg` (reset roll mode), and with `decay_window` one
    more window of DECAY_FOLDS rolled in decay mode. `mode` (one of MODES)
    picks the fold: the captured graphs, or op by op with the kernels or
    with the plain versions. Per window the pre-roll tables (and tier
    arrays), the report, the times and, on the plain run, the per-cell add
    counts of the window's f32 sums. The launch counts are set to 0 just
    before the reset windows and read just after them; on the kernel runs
    every call of a plain version is counted too (there must be none). The
    captured run also keeps its graphs' compile-watch stats. The exporter
    takes `exp_kw` (its feed, pack threads, ladder). With `ring`, the
    ring (its counters), the key tables against the host dictionaries
    (resident rings), the pending buffer's direct rows and the records are
    read before the exporter closes."""
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    from netobserv_tpu_torch.sketch import tiered
    check(mode in MODES, f"unknown mode {mode}")
    adds: dict = {}
    touched: dict = {}
    plain_calls: dict = {}
    ctx = (plain_versions(specs, adds, touched) if mode == "plain"
           else counting_plains(specs, plain_calls))
    out = {}
    with ctx:
        exp = TorchSketchExporter(cfg, batch_size=BATCH, device="cuda",
                                  sink=_discard, capture=mode == "captured",
                                  **(exp_kw or {}))
        for s in specs:
            s["kernel"].launches = 0
        out["windows"] = [
            _window(exp, feed, n_batches, w * FOLDS_PER_WINDOW,
                    FOLDS_PER_WINDOW, adds, touched) for w in range(WINDOWS)]
        out["launches"] = {s["name"]: s["kernel"].launches for s in specs}
        out["folds"], out["rolls"] = exp.folds, exp.rolls
        out["resident_bytes"] = exp.counter_table_bytes()
        if ring:
            from netobserv_tpu_torch.sketch import staging
            out["ring"] = exp.ring
            out["records"] = exp.records
            out["direct_rows"] = exp.pending.direct_rows
            if isinstance(exp.ring, staging.ShardedResidentStagingRing):
                out["key_table_check"] = key_table_check(exp.ring)
        if decay_window:
            exp.reset_sketches, exp.decay_factor = False, DECAY_FACTOR
            for s in specs:
                s["kernel"].launches = 0
            pre = _clone(exp.state.tables)
            win = _window(exp, feed, n_batches, WINDOWS * FOLDS_PER_WINDOW,
                          DECAY_FOLDS, adds, touched)
            win["launches"] = {s["name"]: s["kernel"].launches
                               for s in specs}
            decayed = [tiered.decay_plane(getattr(win["tiers"], p),
                                          DECAY_FACTOR)
                       for p in ("cm_bytes", "cm_pkts")]
            got = (exp.state.tables.cm_bytes, exp.state.tables.cm_pkts)
            win["decay_exact"] = all(_exact(x, y) for pw, pg in zip(
                decayed, got) for x, y in zip(pw, pg))
            win["hll_reset"] = not any(bool(t.any()) for t in (
                exp.state.tables.hll_src, exp.state.tables.hll_per_dst,
                exp.state.tables.hll_per_src))
            win["tiers_moved"] = not all(_exact(x, y) for x, y in zip(
                _tensors(pre), _tensors(exp.state.tables)))
            out["decay"] = win
        out["watch"] = _watch_stats(exp)
        check(mode == "captured" or not out["watch"],
              f"{mode} run captured {out['watch']}")
        exp.close()
    if mode != "plain":
        check(not plain_calls, f"plain versions ran on the card: "
              f"{plain_calls}")
    return out


def key_table_check(ring) -> dict:
    """Every live slot of each region's key table on the card holds the
    words of its key in that region's host dictionary: for a native
    dictionary, the words of each slot below its count look up to that
    slot."""
    import numpy as np
    from netobserv_tpu_torch.datapath import flowpack
    from netobserv_tpu_torch.sketch import carry
    tables = carry.key_table_to_numpy(ring.flat_key_tables())
    live = []
    for r, (table, kd) in enumerate(zip(tables, ring.kdicts)):
        if isinstance(kd, flowpack.NativeKeyDict):
            n = kd.count()
            ok = np.array_equal(kd.slots_of(table[:n]), np.arange(n))
        else:
            slots = np.fromiter(kd.slots.values(), np.int64)
            words = np.frombuffer(b"".join(kd.slots), np.uint32).reshape(
                -1, 10)
            n = len(slots)
            ok = np.array_equal(table[slots], words)
        check(ok, f"region {r}: the key table on the card differs from the "
              "host dictionary")
        live.append(n)
    check(live[0] > 0, "the host dictionary is empty")
    return {"regions": len(live), "live_slots": live, "equal": True,
            "packer": ("native" if isinstance(ring.kdicts[0],
                                              flowpack.NativeKeyDict)
                       else "python")}


def compare_tables(a: dict, b: dict, adds: dict, tier_check=None,
                   min_overlap: float = 0.99) -> dict:
    """Kernel-path vs plain-path tables of one window: a cell that took n
    f32 adds (`adds`) is held to 2 * (n + 1) * 2^-24 relative, except the
    tiered CM tables, which `tier_check(name)` holds to the tier bound;
    every other table is exact, apart from the heavy-hitter table
    (identity overlap, at least `min_overlap`) and its eviction count,
    which follows it."""
    import numpy as np
    worst = 0.0
    tier = {}
    for k in a:
        x, y = a[k], b[k]
        if k.startswith("heavy"):
            continue
        if k == "scalars":
            x, y = x[:-1], y[:-1]  # heavy_evictions, the last, as above
        if tier_check is not None and k in ("cm_bytes", "cm_pkts"):
            tier[k] = tier_check(k)
        elif k in adds:
            x64, y64 = x.astype(np.float64), y.astype(np.float64)
            mag = np.maximum(np.abs(x64), np.abs(y64))
            lim = 2 * (adds[k].astype(np.float64) + 1) * U * mag
            check(bool((np.abs(x64 - y64) <= lim).all()),
                  f"table {k}: outside 2*(n+1)*2^-24 per cell")
            worst = max(worst, float(
                (np.abs(x64 - y64) / np.maximum(mag, 1e-30)).max()))
        else:
            check(np.array_equal(x, y), f"table {k}: differs")
    check(set(adds) <= set(a), f"add counts for unknown tables {set(adds)}")
    ids = lambda t: {(int(h1), int(h2)) for h1, h2, v in zip(  # noqa: E731
        t["heavy_h1"], t["heavy_h2"], t["heavy_valid"]) if v}
    ia, ib = ids(a), ids(b)
    # two empty tables (a window that folded nothing) are the same table
    overlap = len(ia & ib) / len(ia | ib) if ia | ib else 1.0
    check(overlap >= min_overlap,
          f"heavy identities overlap {overlap} < {min_overlap}")
    out = {"max_rel_diff": worst, "bound": "2*(n+1)*2^-24 per cell",
           "max_adds_per_cell": max((float(v.max()) for v in adds.values()),
                                    default=0.0),
           "heavy_identity_overlap": overlap}
    if tier:
        out["tier_bound"] = tier
    return out


def _check_windows(wins, universe, pool) -> list[float]:
    """Recall@100 >= 0.99 and a sane report in every window."""
    from netobserv_tpu_torch.scenarios import traffic
    recalls = [traffic.check_recall(w["tables"]["heavy_words"],
                                    w["tables"]["heavy_valid"], w["feed"],
                                    universe, pool) for w in wins]
    check(min(recalls) >= 0.99, f"recall@100 {recalls} < 0.99")
    for w in wins:
        rep = w["report"]
        rows = len(w["feed"]) * BATCH
        check(rep["Records"] == float(rows),
              f"report records {rep['Records']}")
        check(len(rep["HeavyHitters"]) == 64, "report heavy hitters")
        for v in (rep["Bytes"], rep["DistinctSrcEstimate"],
                  *rep["RttQuantilesUs"].values()):
            check(v == v and abs(v) < float("inf"), "non-finite report value")
    return recalls




def _runs(feed, n_batches: int, specs, cfg, **kw) -> dict:
    """A path's three runs over the same batches (MODES)."""
    return {m: run_windows(feed, n_batches, m, specs, cfg, **kw)
            for m in MODES}


def _window_summary(runs: dict, cmp: list, cmp_eager: list) -> dict:
    run, eager, plain = (runs[m] for m in MODES)
    rows = FOLDS_PER_WINDOW * BATCH

    def secs(r):
        return [w["seconds"] for w in r["windows"]]

    return {"launches": run["launches"], "folds": run["folds"],
            "rolls": run["rolls"], "records_per_window": rows,
            "window_seconds": secs(run),
            "records_per_s": [rows / s for s in secs(run)],
            "state_tables_seconds": [w["tables_seconds"]
                                     for w in run["windows"]],
            "roll_seconds": [w["roll_seconds"] for w in run["windows"]],
            "eager_window_seconds": secs(eager),
            "eager_records_per_s": [rows / s for s in secs(eager)],
            "plain_window_seconds": secs(plain),
            "plain_records_per_s": [rows / s for s in secs(plain)],
            "vs_plain": cmp, "vs_eager": cmp_eager,
            "captured_folds": [{k: v for k, v in w.items()
                                if k != "last_signature"}
                               for w in run["watch"]],
            "distinct_src_estimate": [w["report"]["DistinctSrcEstimate"]
                                      for w in run["windows"]]}


def _want_launches(specs, path: str, folds: int) -> dict:
    """Launches over `folds` folds (ingest calls) of `path`: each kernel's
    launches per fold on that path (zero off it). The HLL folds launch
    makes one a fold whatever its folds: three on the wide and resident
    paths, two on the tiered path and with the fan-out signal off."""
    return {s["name"]: s["per_fold"].get(path, 0) * folds for s in specs}


def _captures(watch: list) -> int:
    """The captures of a run's graphs. Each capture's warm-up runs the
    fold once, eagerly, on clones, and its launches count."""
    return sum(w["compiles"] for w in watch)


def _check_launches(runs: dict, specs, path: str, folds: int,
                    what: str) -> None:
    """The kernel runs launched what the path launches per fold: the eager
    run for each fold, the captured run for each fold and each capture's
    warm-up fold (the captures made within the counted folds)."""
    for m in ("captured", "eager"):
        warm = _captures(runs[m]["watch"]) if m == "captured" else 0
        want = _want_launches(specs, path, folds + warm)
        check(runs[m]["launches"] == want,
              f"{what} {m} launch counts {runs[m]['launches']}, want {want}")


def _warm_captured(name: str) -> bool:
    """A ladder entry of the resident feed, captured when its ring is made
    (`warm_superbatch_ladder`) whether or not a fold calls it."""
    return name.startswith("fold_resident_lanes_x")


def _check_watch(run: dict, replays: dict) -> None:
    """The captured run's graphs: a graph for each feed it folded, one
    capture each, a call per fold of the feed (`replays`, by graph name)
    and no retrace; a graph whose feed was not folded never captured,
    but for a ladder entry, captured at warm-up."""
    names = {w["fn"] for w in run["watch"]}
    check(set(replays) <= names, f"graphs {sorted(names)}, want "
          f"{sorted(replays)}")
    for w in run["watch"]:
        want = replays.get(w["fn"], 0)
        captures = 1 if _warm_captured(w["fn"]) else min(want, 1)
        check(w["compiles"] == captures and w["retraces"] == 0,
              f"{w['fn']}: {w['compiles']} captures, {w['retraces']} "
              "retraces")
        check(w["calls"] == want,
              f"{w['fn']}: {w['calls']} calls, want {want}")


def phase_main_path(specs, universe, pool, dense) -> dict:
    from netobserv_tpu_torch.sketch import state as sk
    cfg = sk.SketchConfig()
    runs = _runs(dense_feeder(dense), len(dense), specs, cfg)
    run, eager, plain = (runs[m] for m in MODES)
    folds = WINDOWS * FOLDS_PER_WINDOW
    _check_launches(runs, specs, "wide", folds, "wide")
    for r in (run, eager):
        check(r["folds"] == folds and r["rolls"] == WINDOWS,
              f"exporter counted {r['folds']} folds, {r['rolls']} rolls")
    _check_watch(run, {"fold_dense": folds})
    recalls = _check_windows(run["windows"], universe, pool)
    cmp = [compare_tables(w["tables"], p["tables"], p["adds"])
           for w, p in zip(run["windows"], plain["windows"])]
    cmp_eager = [compare_tables(w["tables"], e["tables"], p["adds"])
                 for w, e, p in zip(run["windows"], eager["windows"],
                                    plain["windows"])]
    return {"phase": "main_path", "recall_at_100": recalls,
            **_window_summary(runs, cmp, cmp_eager),
            "resident_bytes": run["resident_bytes"],
            "hot_key_rows_per_fold": hot_key_rows(pool)}


def _tier_checker(w: dict, p: dict, tspec, counted: dict | None = None):
    """tier_check for compare_tables: hold one window's decoded CM table
    of the run `w` against the run `p` to the tier bound, with the adds
    counted by the plain run `counted` (default `p`)."""
    import torch
    counted = p if counted is None else counted

    def fn(name: str) -> dict:
        unit = tspec.bytes_unit if name == "cm_bytes" else 1
        n = torch.from_numpy(counted["adds"][name]).cuda()
        f = torch.from_numpy(counted["touched"][name]).cuda()
        return tier_view_check(getattr(w["tiers"], name),
                               getattr(p["tiers"], name), n, f, tspec, unit)

    return fn


def phase_tiered_path(specs, universe, pool, dense) -> dict:
    cfg = tiered_cfg()
    runs = _runs(dense_feeder(dense), len(dense), specs, cfg,
                 decay_window=True)
    run, eager, plain = (runs[m] for m in MODES)
    folds = WINDOWS * FOLDS_PER_WINDOW
    _check_launches(runs, specs, "tiered", folds, "tiered")
    for r in (run, eager):
        check(r["folds"] == folds and r["rolls"] == WINDOWS,
              f"exporter counted {r['folds']} folds, {r['rolls']} rolls")
        dec = r["decay"]
        want_decay = _want_launches(specs, "tiered", DECAY_FOLDS)
        check(dec["launches"] == want_decay,
              f"decay window launches {dec['launches']}, want {want_decay}")
        check(dec["decay_exact"], "decay roll: the tiers are not "
              "decay_plane of the pre-roll tiers")
        check(dec["hll_reset"] and dec["tiers_moved"],
              "decay roll: HLL banks not reset or tiers unchanged")
    _check_watch(run, {"fold_dense": folds + DECAY_FOLDS})
    dec = run["decay"]
    wins = run["windows"] + [dec]
    recalls = _check_windows(wins, universe, pool)
    ewins = eager["windows"] + [eager["decay"]]
    pwins = plain["windows"] + [plain["decay"]]
    cmp = [compare_tables(w["tables"], p["tables"], p["adds"],
                          _tier_checker(w, p, cfg.tiered))
           for w, p in zip(wins, pwins)]
    cmp_eager = [compare_tables(w["tables"], e["tables"], p["adds"],
                                _tier_checker(w, e, cfg.tiered, p))
                 for w, e, p in zip(wins, ewins, pwins)]
    from netobserv_tpu_torch.sketch import tiered
    occ = {p: tiered.plane_occupancy(getattr(run["windows"][-1]["tiers"], p))
           for p in ("cm_bytes", "cm_pkts")}
    return {"phase": "tiered_path", "recall_at_100": recalls,
            **_window_summary(runs, cmp, cmp_eager),
            "decay_window": {"folds": DECAY_FOLDS, "factor": DECAY_FACTOR,
                             "launches": dec["launches"],
                             "seconds": dec["seconds"],
                             "eager_seconds": eager["decay"]["seconds"],
                             "roll_seconds": dec["roll_seconds"],
                             "decay_plane_exact": dec["decay_exact"]},
            "resident_bytes": run["resident_bytes"],
            "tier_occupancy_end_of_window_2": occ}


def phase_native_pack(events) -> dict:
    """The native packer against the Python one on the host of the card's
    machine: the pool's batches as flow events (the resident path's first
    batches), packed chunk by chunk from one start row with each packer and
    its own dictionary (default caps, 2^18 slots): the same regions word
    for word, the same rows consumed and dictionary count, and in the end
    the same slot for every key; with each packer's seconds per batch."""
    import numpy as np
    from netobserv_tpu_torch.datapath import flowpack
    caps = flowpack.default_resident_caps(BATCH)
    kd_n = flowpack.NativeKeyDict(1 << 18)
    kd_p = flowpack.KeyDict(1 << 18)
    secs = {"native": 0.0, "python": 0.0}
    chunks = 0
    for ev, feats in events:
        start = 0
        while start < len(ev):
            t0 = time.perf_counter()
            bn, cn = flowpack.pack_resident_native(ev, BATCH, kd_n, caps,
                                                   start=start, **feats)
            t1 = time.perf_counter()
            bp, cp = flowpack.pack_resident(ev, BATCH, kd_p, caps,
                                            start=start, **feats)
            secs["native"] += t1 - t0
            secs["python"] += time.perf_counter() - t1
            check(cn == cp and cn > 0,
                  f"chunk {chunks}: consumed {cn} native, {cp} Python")
            check(np.array_equal(bn, bp), f"chunk {chunks}: regions differ")
            check(kd_n.count() == kd_p.count(),
                  f"chunk {chunks}: {kd_n.count()} keys native, "
                  f"{kd_p.count()} Python")
            chunks += 1
            start += cn
    words = np.frombuffer(b"".join(kd_p.slots), np.uint32).reshape(-1, 10)
    check(np.array_equal(kd_n.slots_of(words),
                         np.fromiter(kd_p.slots.values(), np.int64)),
          "the dictionaries give other slots")
    n = len(events)
    out = {"phase": "native_pack", "batches": n, "chunks": chunks,
           "keys": kd_n.count(), "regions_equal": True,
           "native_seconds_per_batch": secs["native"] / n,
           "python_seconds_per_batch": secs["python"] / n,
           "python_over_native": secs["python"] / secs["native"]}
    kd_n.close()
    return out


def _ring_summary(run: dict, eager: dict, plain: dict, cfg_note: dict
                  ) -> dict:
    """The checks every feed of events shares, and its per-16,384-record
    numbers: the three runs folded the same dispatches and records, and
    the pack time apart from the rest of a window's time."""
    records = WINDOWS * FOLDS_PER_WINDOW * BATCH
    check(run["records"] == records and run["rolls"] == WINDOWS,
          f"exporter counted {run['records']} records, {run['rolls']} "
          "rolls")
    for other in (eager, plain):
        check(other["folds"] == run["folds"]
              and other["records"] == run["records"],
              "the eager or plain run folded other dispatches")
    ring = run["ring"]
    check(run["folds"] == ring.chunks, f"exporter counted {run['folds']} "
          f"folds, the ring {ring.chunks} dispatches")
    per_batch = FOLDS_PER_WINDOW  # batches of BATCH records in a window

    def per(r, key):
        return [w[key] / per_batch for w in r["windows"]]

    def rest(r):
        return [(w["seconds"] - w["pack_seconds"]) / per_batch
                for w in r["windows"]]

    return {**cfg_note, "dispatches": ring.chunks,
            "records": run["records"], "stalls": ring.stalls,
            "slot_wait_p95_s": ring.slot_wait_p95(),
            "direct_rows": run["direct_rows"],
            "pack_seconds_per_16384": per(run, "pack_seconds"),
            "ingest_seconds_per_16384": rest(run),
            "eager_pack_seconds_per_16384": per(eager, "pack_seconds"),
            "eager_ingest_seconds_per_16384": rest(eager)}


def _compare_runs(runs: dict) -> tuple[list, list]:
    run, eager, plain = (runs[m] for m in MODES)
    cmp = [compare_tables(w["tables"], p["tables"], p["adds"])
           for w, p in zip(run["windows"], plain["windows"])]
    cmp_eager = [compare_tables(w["tables"], e["tables"], p["adds"])
                 for w, e, p in zip(run["windows"], eager["windows"],
                                    plain["windows"])]
    return cmp, cmp_eager


def phase_resident_path(specs, universe, pool, events) -> dict:
    """The resident feed at full width: `fold_events` over the event form
    of the same pool batches, at one lane and the ladder (1,) (one region
    of B = 16,384, default caps, 2^18 slots, what the one-lane ring
    ships), the native packer."""
    from netobserv_tpu_torch.datapath import flowpack
    from netobserv_tpu_torch.scenarios import traffic
    from netobserv_tpu_torch.sketch import state as sk
    cfg = sk.SketchConfig()
    runs = _runs(event_feeder(events), len(events), specs, cfg, ring=True,
                 exp_kw=RESIDENT_KW)
    run, eager, plain = (runs[m] for m in MODES)
    ring = run["ring"]
    check(ring.lanes == 1 and ring.ladder == (1,),
          f"{ring.lanes} lanes, ladder {ring.ladder}")
    check(run["folds"] == WINDOWS * FOLDS_PER_WINDOW + ring.continuations,
          f"{run['folds']} dispatches, {ring.continuations} continuations")
    check(isinstance(ring.kdicts[0], flowpack.NativeKeyDict),
          "the exporter's ring does not pack natively")
    _check_launches(runs, specs, "resident", run["folds"], "resident")
    _check_watch(run, {"fold_resident_lanes_x1": run["folds"]})
    recalls = _check_windows(run["windows"], traffic.event_universe(universe),
                             pool)
    cmp, cmp_eager = _compare_runs(runs)
    records = WINDOWS * FOLDS_PER_WINDOW * BATCH
    h2d = ring.chunks * flowpack.resident_buf_len(BATCH, ring.caps) * 4
    return {"phase": "resident_path", "recall_at_100": recalls,
            **_window_summary(runs, cmp, cmp_eager),
            **_ring_summary(run, eager, plain, {
                "caps": repr(ring.caps), "slot_cap": ring.slot_cap,
                "packer": "native", "lanes": ring.lanes,
                "ladder": list(ring.ladder)}),
            "continuations": ring.continuations,
            "dict_resets": ring.dict_resets, "spill_rows": ring.spill_rows,
            "key_table": run["key_table_check"],
            "h2d_bytes_per_record": h2d / records,
            "dense_h2d_bytes_per_record": sk.DENSE_WORDS * 4}


def phase_lanes_path(specs, universe, pool, events) -> dict:
    """The reference agent's default feed at full width: the default
    exporter (8 lanes of 2,048 rows, ladder (1, 2, 4), 2^18 slots a lane,
    the native packer) fed the pool's records as evictions of seeded sizes
    (`LaneFeeder`), each window rolled after its 32 x 16,384 records."""
    import os
    from netobserv_tpu_torch.datapath import flowpack
    from netobserv_tpu_torch.scenarios import traffic
    from netobserv_tpu_torch.sketch import state as sk
    cfg = sk.SketchConfig()
    feeder = LaneFeeder(events)
    runs = _runs(feeder, len(events), specs, cfg, ring=True,
                 exp_kw=LANES_KW)
    run, eager, plain = (runs[m] for m in MODES)
    ring = run["ring"]
    check(ring.lanes == 8 and ring.ladder == (1, 2, 4),
          f"{ring.lanes} lanes, ladder {ring.ladder}")
    check(all(ring.superbatch_folds.get(k, 0) > 0 for k in (1, 2, 4)),
          f"superbatch folds {ring.superbatch_folds}")
    for other in (eager, plain):
        check(other["ring"].superbatch_folds == ring.superbatch_folds,
              "the eager or plain run took other ladder entries")
    check(run["direct_rows"] > 0, "no eviction took the direct path")
    check(all(isinstance(kd, flowpack.NativeKeyDict) for kd in ring.kdicts),
          "the exporter's ring does not pack natively")
    _check_launches(runs, specs, "lanes", run["folds"], "lanes")
    _check_watch(run, {f"fold_resident_lanes_x{k}": n
                       for k, n in ring.superbatch_folds.items()})
    check(_captures(run["watch"]) == 3, f"captures {run['watch']}")
    recalls = _check_windows(run["windows"], traffic.event_universe(universe),
                             pool)
    cmp, cmp_eager = _compare_runs(runs)
    records = WINDOWS * FOLDS_PER_WINDOW * BATCH
    h2d = sum(n * k * ring.n_regions * ring._region_words * 4
              for k, n in ring.superbatch_folds.items())
    sizes = feeder.sizes
    return {"phase": "lanes_path", "recall_at_100": recalls,
            **_window_summary(runs, cmp, cmp_eager),
            **_ring_summary(run, eager, plain, {
                "lanes": ring.lanes, "ladder": list(ring.ladder),
                "pack_threads": ring.pack_threads,
                "cpu_count": os.cpu_count(), "caps": repr(ring.caps),
                "slot_cap": ring.slot_cap, "packer": "native"}),
            "evictions": len(sizes), "eviction_rows_min": min(sizes),
            "eviction_rows_max": max(sizes),
            "superbatch_folds": {str(k): v for k, v in
                                 sorted(ring.superbatch_folds.items())},
            "continuations": ring.continuations,
            "dict_resets": ring.dict_resets, "spill_rows": ring.spill_rows,
            "key_table": run["key_table_check"],
            "h2d_bytes_per_record": h2d / records}


class WindowSink:
    """The window_thread phase's sink: keeps each report and the span of
    each call, sleeping `sleep` seconds a call (a slow sink)."""

    def __init__(self, sleep: float = 0.0):
        self.sleep = sleep
        self.reports: list = []
        self.spans: list = []

    def __call__(self, report: dict) -> None:
        t0 = time.perf_counter()
        if self.sleep:
            time.sleep(self.sleep)
        self.reports.append(report)
        self.spans.append((t0, time.perf_counter()))


class DispatchFailure:
    """A seam of this script on a lane ring: the `at`-th fold call of the
    ring (1-based; `arm_next` names the next one) raises at its first
    dispatch of a ladder entry, after its chunk packed, once. Keeps that
    call's events, and at the raise the ring's `dict_resets` and the
    exporter's open window (its `rolls`)."""

    def __init__(self, exp, at: int | None = None):
        self.exp = exp
        ring = self.ring = exp.ring
        self.at = at
        self.calls = 0
        self.armed = False
        self.fired = 0
        self.events = None
        self.resets_at_raise = None
        self.window = None
        self._fold, self._dispatch = ring.fold, ring._dispatch
        ring.fold, ring._dispatch = self.fold, self.dispatch

    def arm_next(self) -> None:
        self.at = self.calls + 1

    def fold(self, state, events, *args, **kw):
        self.calls += 1
        self.armed = self.calls == self.at
        if self.armed:
            self.events = events.copy()
        return self._fold(state, events, *args, **kw)

    def dispatch(self, k, state, flat):
        if self.armed:
            self.armed = False
            self.fired += 1
            self.resets_at_raise = self.ring.dict_resets
            self.window = self.exp.rolls
            raise RuntimeError("injected dispatch failure")
        return self._dispatch(k, state, flat)


class RollSeam:
    """Counts the evictions appended to an exporter's pending buffer (under
    its lock) and, at each roll, notes that count and (with `keep_state`)
    a device clone of the pre-roll state, and on the plain replay the
    window's per-cell adds."""

    def __init__(self, exp, adds: dict | None = None,
                 touched: dict | None = None, keep_state: bool = True):
        self.exp = exp
        self.appended = 0
        self.rolls: list = []  # (evictions appended, state clone, adds)
        self._adds, self._touched = adds, touched
        self._keep = keep_state
        self._append, self._roll = exp.pending.append, exp._roll_locked
        exp.pending.append, exp._roll_locked = self.append, self.roll

    def append(self, evicted, fold) -> None:
        self.appended += 1
        self._append(evicted, fold)

    def roll(self, *args):
        adds = None
        if self._adds is not None:
            adds = {k: v.cpu().numpy() for k, v in self._adds.items()}
            self._adds.clear()
            self._touched.clear()
        self.rolls.append((self.appended,
                           _clone(self.exp.state) if self._keep else None,
                           adds))
        return self._roll(*args)


def _stream_evictions(n_rows: int):
    """(lo, hi) of the lanes path's evictions over a stream of n_rows,
    pass after pass: EVICT_ROWS three times in four, else uniform over
    EVICT_LARGE, the last of a pass cut at its end (sizes from
    `numpy.random.default_rng(1)`, as `LaneFeeder` draws them)."""
    import numpy as np
    rng = np.random.default_rng(1)
    while True:
        end = 0
        while end < n_rows:
            size = (EVICT_ROWS if rng.random() < 0.75
                    else int(rng.integers(*EVICT_LARGE)))
            lo, end = end, min(end + size, n_rows)
            yield lo, end


def _window_recall(words, valid, evictions, ranks, nbytes, universe,
                   dropped=None, index=None, k: int = 100) -> float:
    """Recall@k of a heavy-hitter table against the exact byte totals of
    the stream rows of `evictions` ((lo, hi) each), less the `dropped`
    flow events (keys looked up in `index`)."""
    import numpy as np
    from netobserv_tpu_torch.model.columnar import pack_key_words
    n = len(universe)
    totals = np.zeros(n)
    for lo, hi in evictions:
        totals += np.bincount(ranks[lo:hi], weights=nbytes[lo:hi],
                              minlength=n)
    if dropped is not None:
        r = np.array([index[w.tobytes()]
                      for w in pack_key_words(dropped["key"])])
        totals -= np.bincount(r, weights=dropped["stats"]["bytes"].astype(
            np.float64), minlength=n)
    top = np.argsort(-totals, kind="stable")[:k]
    got = {tuple(w) for w, v in zip(np.asarray(words, np.uint32),
                                    np.asarray(valid)) if v}
    return sum(tuple(universe[t]) in got for t in top) / k


#: the fused_drain phase (module docstring, `fused_drain`): the gate's
#: drain lanes, the per-CPU images of each feature map, the share of
#: feature rows that are orphans, the feature maps, and the eviction of
#: window 1 whose pack the stale-epoch check holds back
FD_LANES = 4
FD_CPUS = 8
FD_ORPHANS = 0.02
FD_KINDS = ("extra", "dns", "drops")
FD_SEED = 21


def _split_maps(rng, events, feats, n_cpus: int = FD_CPUS) -> list:
    """An eviction as a drain's injected maps: [(keys (n, 40) u8, values
    (n, n_cpus) records)], the aggregation map (the stats, one CPU) first,
    then each of FD_KINDS at `n_cpus` CPUs, whose partials merge to the
    row's record (the drop counters split over the CPUs at seeded cuts,
    every other field the record's on each CPU), about FD_ORPHANS of its
    rows under a key the aggregation map lacks (its pad byte set)."""
    import numpy as np
    n = len(events)
    keys = np.ascontiguousarray(events["key"]).view(np.uint8).reshape(n, 40)
    maps = [(keys, np.ascontiguousarray(events["stats"])[:, None])]
    for kind in FD_KINDS:
        rec = np.ascontiguousarray(feats[kind])
        fk = keys.copy()
        orphan = rng.random(n) < FD_ORPHANS
        fk[orphan, 39] = 0xA5
        parts = np.repeat(rec[:, None], n_cpus, axis=1)
        if kind == "drops":
            for col in ("bytes", "packets"):
                total = rec[col].astype(np.int64)
                cut = np.sort((rng.random((n, n_cpus - 1))
                               * (total[:, None] + 1)).astype(np.int64),
                              axis=1)
                edges = np.concatenate([np.zeros((n, 1), np.int64), cut,
                                        total[:, None]], axis=1)
                parts[col] = np.diff(edges, axis=1)
        maps.append((fk, np.ascontiguousarray(parts)))
    return maps


class _InjectedMaps:
    """The kernel fetchers' duck type (`datapath/loader.py` module
    docstring) over injected maps (fd < 0), with the gate's binding hook:
    `drain(maps)` is one drain of `maps`, fused once the gate is engaged
    (its rows injected into the pipe first, outside the drain's time),
    else through the port's Python chain (`decode_eviction`)."""

    def __init__(self, lanes: int):
        from netobserv_tpu_torch.datapath import flowpack, loader

        class Map:
            def __init__(self, dtype, n_cpus):
                self.fd, self.n_cpus, self.max_entries = -1, n_cpus, 1 << 20
                self._no_batch_ops, self._pad_vs = False, dtype.itemsize

        self._loader = loader
        self._agg = Map(flowpack.PIPE_DTYPES["stats"], 1)
        self._features = {k: (Map(flowpack.PIPE_DTYPES[k], FD_CPUS),
                              flowpack.PIPE_DTYPES[k]) for k in FD_KINDS}
        self.gate = loader.NativeEvictPipeline(self, lanes)
        #: seconds spent injecting rows (the stand-in for the kernel
        #: drain's copy, which the native call's drain stage then skips)
        self.inject_s = 0.0

    def bind_pack_surface(self, surface) -> None:
        self.gate.bind_pack_surface(surface)

    def python_chain(self, maps):
        return self._loader.decode_eviction(
            maps[0][0], maps[0][1],
            {k: maps[i + 1] for i, k in enumerate(FD_KINDS)})

    def drain(self, maps):
        from netobserv_tpu_torch.utils import tracing
        gate = self.gate
        if gate._drains and not gate.disabled and (
                gate._pipe is not None or gate._build()):
            t0 = time.perf_counter()
            for i, (k, v) in enumerate(maps):
                gate._pipe.set_drained(i, k, v)
            self.inject_s += time.perf_counter() - t0
        out = gate.drain(tracing.NULL_TRACE, time.perf_counter())
        return out if out is not None else self.python_chain(maps)


class _ShipRecorder:
    """On a lane ring: every slot zeroed when it is taken (as a fresh
    ring's are, so an exhausted region's unread words compare too), and
    every image it ships kept in `images`."""

    def __init__(self, ring):
        self.images: list = []
        wait, ship = ring._wait_slot, ring._ship

        def wait_slot(*a):
            slot = wait(*a)
            ring._bufs[slot][:] = 0
            return slot

        def ship_slot(slot, words=None):
            self.images.append(ring._bufs[slot][:words].copy())
            return ship(slot, words)

        ring._wait_slot, ring._ship = wait_slot, ship_slot


def _fd_exporter():
    """The lanes path's exporter (LANES_KW, default geometry), its ring
    and ladder captured, and its pack surface."""
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    from netobserv_tpu_torch.sketch import state as sk
    exp = TorchSketchExporter(sk.SketchConfig(), batch_size=BATCH,
                              sink=_discard, **LANES_KW)
    surface = exp.resident_pack_surface()
    check(surface is not None and exp.ring.lanes == 8,
          "the lanes exporter offers no pack surface")
    return exp, surface


def _unpacked(ev):
    from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
    return EvictedFlows(ev.events, **{k: getattr(ev, k) for k in FD_KINDS})


def _fd_timed(specs, windows: list, fused: bool) -> dict:
    """One timed run over `windows` (each a list of an eviction's maps):
    the fused gate into a fresh exporter, or the Python chain into
    another; window 0 on the wall clock, window 1 under torch.profiler
    (the device's busy share); the launches, captures and retraces."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from netobserv_tpu_torch.utils import retrace
    exp, surface = _fd_exporter()
    maps_in = _InjectedMaps(FD_LANES)
    if fused:
        maps_in.bind_pack_surface(surface)
    captures0 = [c.captures for c in exp.captures]
    retraces0 = retrace.total_retraces()
    torch.cuda.synchronize()
    for s in specs:
        s["kernel"].launches = 0
    folds0 = exp.folds
    walls, busy, native, segs = [], None, {}, 0
    chain_s = export_s = packed_s = 0.0
    decode = {"merge_s": 0.0, "align_s": 0.0}
    pack0 = exp.ring.pack_seconds
    try:
        for w, window in enumerate(windows):
            prof = profile(activities=[ProfilerActivity.CUDA]) if w else None
            if prof is not None:
                prof.__enter__()
            t0 = time.perf_counter()
            for maps in window:
                t1, inj = time.perf_counter(), maps_in.inject_s
                ev = maps_in.drain(maps) if fused else \
                    maps_in.python_chain(maps)
                chain_s += time.perf_counter() - t1 - (maps_in.inject_s
                                                       - inj)
                st = ev.decode_stats
                for k, v in (st.get("native") or {}).items():
                    native[k] = native.get(k, 0.0) + v
                if "native" not in st:
                    for k in decode:
                        decode[k] += st[k]
                packed = ev.packed is not None
                if packed:
                    segs += ev.packed.segs
                t1 = time.perf_counter()
                exp.export_evicted(ev)
                export_s += time.perf_counter() - t1
                if packed:
                    packed_s += time.perf_counter() - t1
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if prof is not None:
                prof.__exit__(None, None, None)
                rows = _device_rows(prof)
                check(rows, "the profiler saw no device time")
                busy = sum(r[0] for r in rows) / 1e6 / walls[-1]
            exp.roll()
        torch.cuda.synchronize()
        launches = {s["name"]: s["kernel"].launches for s in specs}
        folds = exp.folds - folds0
        check(launches == _want_launches(specs, "lanes", folds),
              f"fused={fused}: launches {launches} for {folds} folds")
        check([c.captures for c in exp.captures] == captures0
              and [c.captures for c in exp.ring.captures] == [1, 1, 1]
              and retrace.total_retraces() == retraces0,
              f"fused={fused}: captures {captures0} -> "
              f"{[c.captures for c in exp.captures]}, retraces")
        ring = exp.ring
        _check_watch({"watch": _watch_stats(exp)},
                     {f"fold_resident_lanes_x{k}": n
                      for k, n in ring.superbatch_folds.items()})
        rows = sum(len(m[0][0]) for win in windows for m in win)
        per = BATCH / rows * 1e3  # ms per 16,384 records per second
        return {"records_per_s": [
                    sum(len(m[0][0]) for m in win) / wl
                    for win, wl in zip(windows, walls)],
                "wall_s": walls, "device_busy_share_window1": busy,
                "host_ms_per_16384": (
                    {k[:-2]: v * per for k, v in native.items()}
                    if fused else {k[:-2]: v * per
                                   for k, v in decode.items()}),
                "ring_pack_ms_per_16384": (ring.pack_seconds - pack0) * per,
                "fold_packed_ms_per_16384": packed_s * per if fused else None,
                "chain_ms_per_16384": chain_s * per,
                "inject_ms_per_16384": maps_in.inject_s * per,
                "export_ms_per_16384": export_s * per,
                "folds": folds, "launches": launches,
                "superbatch_folds": {str(k): v for k, v in
                                     sorted(ring.superbatch_folds.items())},
                "spill_rows": ring.spill_rows,
                "dict_resets": ring.dict_resets, "segs": segs,
                "fused_drains": maps_in.gate._drains - 1 if fused else 0,
                "rows": rows}
    finally:
        exp.close()
        maps_in.gate.close()


def phase_fused_drain(specs, events, card: str) -> dict:
    """The fused drain's seam on the card (module docstring,
    `fused_drain`)."""
    import os
    import numpy as np
    t_phase = time.perf_counter()
    ev_all, lanes_all = _integer_stream(events)
    gen = _stream_evictions(len(ev_all))
    cuts = []
    for _ in range(WINDOWS):
        cut, end = [], 0
        while end < len(ev_all):
            lo, end = next(gen)
            cut.append((lo, end))
        cuts.append(cut)
    rng = np.random.default_rng(FD_SEED)
    windows = [[_split_maps(rng, ev_all[lo:hi],
                            {k: lanes_all[k][lo:hi] for k in FD_KINDS})
                for lo, hi in cut] for cut in cuts]
    t_maps = time.perf_counter() - t_phase
    plains: dict = {}
    with counting_plains(specs, plains):
        raw_run = _fd_timed(specs, windows, fused=False)
        fused_run = _fd_timed(specs, windows, fused=True)
        checks = _fd_checked(windows, cuts)
    check(not plains, f"plain versions ran {plains}")
    check(fused_run["fused_drains"] == sum(map(len, windows)) - 1,
          f"{fused_run['fused_drains']} fused drains")
    return {"phase": "fused_drain", "card": card, "lanes": FD_LANES,
            "cpu_count": os.cpu_count(), "n_cpus": FD_CPUS,
            "orphan_share": FD_ORPHANS, "evictions": sum(map(len, cuts)),
            "eviction_rows": [hi - lo for lo, hi in cuts[0]][:8],
            "maps_build_s": t_maps, "fused": fused_run, "raw": raw_run,
            "records_per_s_fused_over_raw": (
                fused_run["records_per_s"][0] / raw_run["records_per_s"][0]),
            "checks": checks, "launches": fused_run["launches"],
            "raw_launches": raw_run["launches"],
            "seconds": time.perf_counter() - t_phase}


def _fd_checked(windows: list, cuts: list) -> dict:
    """The checked run: a fused exporter and a raw twin of its settings in
    lock step over `windows`. Each fused drain's events and features
    against the Python chain of the same maps, byte for byte; each arena
    against the twin's ring's pack of the same rows (`_ShipRecorder`),
    byte for byte, every row of the twin's pending buffer folded first
    (a fused eviction ships at once, its last partial batch too); at the
    first eviction of window 1 with a whole batch after it, that
    eviction's arena held back while the next folds raw (the twin's
    dictionaries take the same epoch roll), then discarded for its stale
    epoch and its rows folded raw; every window's pre-roll tables bit for
    bit."""
    import numpy as np
    import torch
    from netobserv_tpu_torch.sketch import state as sk
    fexp, surface = _fd_exporter()
    twin, tsurface = _fd_exporter()
    rec = _ShipRecorder(twin.ring)
    maps_in = _InjectedMaps(FD_LANES)
    maps_in.bind_pack_surface(surface)
    out = {"drains_checked": 0, "arenas_checked": 0, "stale_discards": 0,
           "windows_bit_equal": 0, "arena_words": 0}

    def drain_both():
        for x in (fexp, twin):
            with x._lock:
                x._drain_pending()

    def one(maps, hold=False):
        if maps_in.gate._drains and len(fexp.pending):
            drain_both()  # before the pack: a raw fold after it stales it
        ev = maps_in.drain(maps)
        want = maps_in.python_chain(maps)
        check(ev.events.tobytes() == want.events.tobytes()
              and all(getattr(ev, k).tobytes() == getattr(want, k).tobytes()
                      for k in FD_KINDS),
              "a fused drain's events or features differ from the Python "
              "chain's")
        out["drains_checked"] += 1
        if hold:
            return ev
        export(ev)

    def export(ev):
        packed = ev.packed
        shipped = packed is not None and packed.epoch == surface.epoch
        arena = packed.arena.copy() if shipped else None
        rec.images.clear()
        twin.export_evicted(_unpacked(ev))
        if shipped:
            with twin._lock:
                twin._drain_pending()
            got = np.concatenate(rec.images) if rec.images else None
            check(got is not None and got.tobytes() == arena.tobytes(),
                  "a fused arena differs from the ring's own pack of its "
                  "rows")
            out["arenas_checked"] += 1
            out["arena_words"] += len(arena)
        fexp.export_evicted(ev)

    try:
        for w, window in enumerate(windows):
            i = 0
            stale_at = (next(j for j in range(len(window) - 1)
                             if len(window[j + 1][0][0]) >= BATCH)
                        if w == 1 else None)
            while i < len(window):
                if i == stale_at:
                    held = one(window[i], hold=True)
                    check(held.packed is not None
                          and surface.outstanding == 1,
                          "no arena outstanding to hold")
                    arena = held.packed
                    tsurface.outstanding += 1  # the twin's epoch roll
                    raw = maps_in.python_chain(window[i + 1])
                    twin.export_evicted(_unpacked(raw))
                    fexp.export_evicted(raw)
                    check(surface.outstanding == 0 and surface.epoch
                          == tsurface.epoch == 1, "the raw fold did not "
                          "roll the surface's epoch")
                    twin.export_evicted(_unpacked(held))
                    fexp.export_evicted(held)
                    check(arena.arena is None and held.packed is None,
                          "the stale arena was not freed")
                    out["stale_discards"] += 1
                    i += 2
                    continue
                one(window[i])
                i += 1
            drain_both()
            got, want = (sk.state_tables(x.state) for x in (fexp, twin))
            diff = [k for k in want if not np.array_equal(got[k], want[k])]
            check(not diff, f"window {w}: tables {diff} differ from the "
                  "raw twin's")
            out["windows_bit_equal"] += 1
            check(fexp.records == twin.records, "records differ")
            fexp.roll()
            twin.roll()
        torch.cuda.synchronize()
        check(fexp.ingest_errors == twin.ingest_errors == 0, "ingest errors")
        out["fused_folds"], out["twin_folds"] = fexp.folds, twin.folds
        return out
    finally:
        fexp.close()
        twin.close()
        maps_in.gate.close()


#: the kernel datapath phase (`kernel_datapath`): the capacity of the
#: pinned maps, the drain lanes, the seed of the map contents' splits
KD_CAPACITY = 131_072
KD_LANES = 8
KD_SEED = 22
#: the live capture: datagrams of KD_LIVE_PAYLOAD bytes from one source
#: port, KD_LIVE_PER_PORT to each of KD_LIVE_PORTS destination ports
KD_LIVE_SPORT = 45_123
KD_LIVE_PORTS = range(47_000, 47_300)
KD_LIVE_PER_PORT = 2
KD_LIVE_PAYLOAD = 120
#: the fixed tracepoint offsets of the probe programs' builds
KD_RTT_FIELDS = {"saddr": 8, "daddr": 36, "sport": 64, "dport": 66,
                 "family": 68, "srtt": 92}
KD_DROP_FIELDS = {"skbaddr": 8, "reason": 28}
#: the fixed map fds of the builds, one integer a map
KD_FDS = {"ringbuf_fd": 11, "counters_fd": 12, "dns_inflight_fd": 13,
          "flows_dns_fd": 14, "rtt_inflight_fd": 15, "flows_extra_fd": 16,
          "filter_rules_fd": 17, "filter_peers_fd": 18, "flows_quic_fd": 19,
          "sampling_gate_fd": 20}


class KdOffsets:
    """Fixed sk_buff and sock offsets, the BTF reader of the drop
    program's fixed build."""

    TABLE = {("sk_buff", "len"): 112, ("sk_buff", "head"): 200,
             ("sk_buff", "network_header"): 182,
             ("sk_buff", "transport_header"): 180, ("sk_buff", "sk"): 24,
             ("sock", "__sk_common.skc_state"): 18}

    def offset_of(self, struct_name: str, path: str) -> int:
        return self.TABLE[(struct_name, path)]


def kd_program_args() -> list:
    """Every program of the builders at fixed arguments, as (name, module
    of `datapath/`, builder, args, kwargs): both directions of the flow
    program with no feature and with every feature's fds set, the probe
    programs with and without the sampling gate, the SSL-write and PCA
    programs."""
    all_fds = {**KD_FDS, "dns_port": 53, "quic_mode": 2, "enable_tls": True,
               "has_filter_sampling": True}
    out = []
    for d in (0, 1):
        out.append((f"flow_dir{d}_none", "asm_flowpath",
                    "build_flow_program", (3,), {"direction": d}))
        out.append((f"flow_dir{d}_all", "asm_flowpath", "build_flow_program",
                    (3,), {"direction": d, "sampling": 50, **all_fds}))
    for gate in (None, 20):
        g = "gate" if gate else "nogate"
        out.append((f"rtt_{g}", "asm_probes", "build_rtt_tracepoint_program",
                    (dict(KD_RTT_FIELDS), 16, gate), {}))
        out.append((f"drops_{g}", "asm_probes", "build_drops_program",
                    (KdOffsets(), 21, dict(KD_DROP_FIELDS)),
                    {"sampling_gate_fd": gate}))
    out.append(("ssl_write", "asm_ssl", "build_ssl_write_program", (9,), {}))
    out.append(("pca_none", "asm_pca", "build_pca_program", (9,), {}))
    out.append(("pca_all", "asm_pca", "build_pca_program", (9,),
                {"sampling": 4, "direction": 1, "filter_rules_fd": 17,
                 "filter_peers_fd": 18, "counters_fd": 12}))
    return out


#: SHA-256 of each program of `kd_program_args`, the reference builders'
#: (tests/test_torch_asm.py holds this table against them)
KD_PROGRAM_SHA256 = {
    "flow_dir0_none":
        "357e53706a517be722298b1c2391986b1630e62268f07b69d5560437193e30e1",
    "flow_dir0_all":
        "41cf07a11503ee3939a33c6c6cc76302dd18150e2408c633eec0af9614982a1f",
    "flow_dir1_none":
        "bdaf08725eac7652f718043cc1772d007f97dc6aa9c7b640815ff92a7df6b22f",
    "flow_dir1_all":
        "1dfe27782be2f7e5095600eb85c77f5a74168ccbf335e199fb1c2cb8d033b235",
    "rtt_nogate":
        "8b583c16b295eb239e4e3965d0177c1a9cc6ff06e640cccfb4121337b625749b",
    "drops_nogate":
        "7cfc19af7a5c51d792cf24487e99b1080d3823560aea049e9170b6e636ccf858",
    "rtt_gate":
        "e294901c18a7f98af0571d09332ba704acda45cf323f83d650fcdd36764ceffd",
    "drops_gate":
        "1053aa41ce00b288e6a764eef75813640bf3d521bade8c2d419abccbb1a00547",
    "ssl_write":
        "7f3243922623ec36ec3d8ca4b80a878022fbe8265319705c57dd3f4ab46f6cc7",
    "pca_none":
        "6cf4e748c1b06e0059ed0850df2978e05a3538feaffb96b20cb16ba88fdcd0dd",
    "pca_all":
        "d2d385631989f767bcb1a9c8f0991dcd839af2f870448c64a9499ce7b2af8e56"}


def _kd_builders() -> dict:
    """Part 1: every program of `kd_program_args` from the port's builders,
    each against its SHA-256 in KD_PROGRAM_SHA256; then the probe programs
    at the live kernel's offsets where tracefs is mounted and vmlinux BTF
    exists (not mounted: the fixed table; a reader would mount it)."""
    import hashlib
    import importlib
    import os
    from netobserv_tpu_torch.datapath import btf, uprobe
    progs = {}
    for name, mod, fn, args, kw in kd_program_args():
        code = getattr(importlib.import_module(
            f"netobserv_tpu_torch.datapath.{mod}"), fn)(*args, **kw)
        progs[name] = {"insns": len(code) // 8,
                       "sha256": hashlib.sha256(code).hexdigest()}
    bad = [n for n, p in progs.items()
           if p["sha256"] != KD_PROGRAM_SHA256.get(n)]
    check(not bad, f"programs {bad} differ from the reference builders'")
    live = {}
    from netobserv_tpu_torch.datapath import asm_probes
    if os.path.isdir(os.path.join(uprobe._TRACEFS, "events")):
        rtt = uprobe.tracepoint_fields("tcp", "tcp_probe")
        live["rtt_live"] = asm_probes.build_rtt_tracepoint_program(rtt, 16)
        if btf.available():
            live["drops_live"] = asm_probes.build_drops_program(
                btf.kernel_btf(), 21, uprobe.tracepoint_fields(
                    "skb", "kfree_skb"))
    for name, code in live.items():
        check(code and len(code) % 8 == 0, f"{name}: no program")
        progs[name] = {"insns": len(code) // 8,
                       "sha256": hashlib.sha256(code).hexdigest()}
    return progs


def _kd_probe_bpf() -> str | None:
    """None where this process can create BPF maps and pin them on a
    writable bpffs; else the missing capability."""
    import errno
    import os
    from netobserv_tpu_torch.datapath import syscall_bpf as sb
    try:
        sb.BpfMap.create(1, 4, 8, 4, b"probe").close()
    except OSError as exc:
        return f"bpf(2): {errno.errorcode.get(exc.errno, exc.errno)}"
    if not (os.path.ismount("/sys/fs/bpf")
            and os.access("/sys/fs/bpf", os.W_OK)):
        return "bpffs: not mounted writable at /sys/fs/bpf"
    return None


def _kd_unique(ev, lanes):
    """An eviction as a map holds it, each key once: the k-th repeat of
    a key within the eviction takes another source port (a connection
    of its own), and a key still repeated after is dropped."""
    import numpy as np
    n = len(ev)
    ev = ev.copy()
    lanes = {k: v.copy() for k, v in lanes.items()}

    def void(e):
        return np.ascontiguousarray(e["key"]).view(
            np.dtype((np.void, 40))).ravel()

    _u, inv = np.unique(void(ev), return_inverse=True)
    order = np.argsort(inv, kind="stable")
    starts = np.r_[0, np.flatnonzero(np.diff(inv[order])) + 1]
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n) - np.repeat(starts, np.diff(np.r_[starts,
                                                                  n]))
    sp = ev["key"]["src_port"].astype(np.int64)
    ev["key"]["src_port"] = (sp ^ ((rank * 0x9E37) & 0xFFFF)).astype(
        ev["key"]["src_port"].dtype)
    _u, first = np.unique(void(ev), return_index=True)
    keep = np.sort(first)
    return ev[keep], {k: v[keep] for k, v in lanes.items()}


class _KdMaps:
    """The maps bpfman would pin, made and pinned under a directory of the
    phase's own: the aggregation map, the per-CPU extra, DNS and drop maps
    over every possible CPU, and the global counters."""

    def __init__(self):
        import os
        from netobserv_tpu_torch.datapath import flowpack
        from netobserv_tpu_torch.datapath import syscall_bpf as sb
        from netobserv_tpu_torch.model import binfmt
        from netobserv_tpu_torch.model.flow import GlobalCounter
        self.dir = f"/sys/fs/bpf/netobserv_torch_smoke_{os.getpid()}"
        self.n_cpus = sb.n_possible_cpus()
        self.maps = {}
        os.makedirs(self.dir, exist_ok=True)
        try:
            self.maps["aggregated_flows"] = sb.BpfMap.create(
                1, 40, binfmt.FLOW_STATS_DTYPE.itemsize, KD_CAPACITY, b"agg")
            for kind in FD_KINDS:
                self.maps[f"flows_{kind}"] = sb.BpfMap.create(
                    5, 40, flowpack.PIPE_DTYPES[kind].itemsize, KD_CAPACITY,
                    kind.encode())
            self.maps["global_counters"] = sb.BpfMap.create(
                6, 4, 8, int(GlobalCounter.MAX), b"ctrs")
            for name, m in self.maps.items():
                m.pin(os.path.join(self.dir, name))
        except BaseException:
            self.close()
            raise

    def fill(self, maps: list) -> float:
        """One eviction's contents (`_split_maps`) into the maps; seconds."""
        t0 = time.perf_counter()
        for (keys, vals), name in zip(maps, ["aggregated_flows"] + [
                f"flows_{k}" for k in FD_KINDS]):
            bpf_update_batch(self.maps[name], keys, vals)
        return time.perf_counter() - t0

    def close(self) -> None:
        import shutil
        for m in self.maps.values():
            m.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def _kd_evictions(events, n_cpus: int) -> list:
    """The fused drain phase's evictions of EVICT_LARGE rows (the integer
    stream cut by `_stream_evictions`, both windows), each made a map's
    content (`_kd_unique`) and split over `n_cpus` CPUs (`_split_maps`,
    seed KD_SEED)."""
    import numpy as np
    ev_all, lanes_all = _integer_stream(events)
    gen = _stream_evictions(len(ev_all))
    out, rng = [], np.random.default_rng(KD_SEED)
    for _ in range(WINDOWS):
        end = 0
        while end < len(ev_all):
            lo, end = next(gen)
            if end - lo < EVICT_LARGE[0]:
                continue
            ev, lanes = _kd_unique(ev_all[lo:end], {
                k: lanes_all[k][lo:end] for k in FD_KINDS})
            out.append(_split_maps(rng, ev, lanes, n_cpus))
    return out


def _kd_timed(specs, kmaps, evictions: list, fused: bool) -> dict:
    """One timed run over `evictions`: each filled into the real maps,
    then drained by the port's `BpfmanFetcher` (KD_LANES lanes; `fused`:
    EVICT_NATIVE_PIPELINE, bound to the exporter's pack surface) and
    exported, the device synchronized before and after (the fill is not
    timed); the second half under torch.profiler for the busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from netobserv_tpu_torch.datapath.loader import BpfmanFetcher
    from netobserv_tpu_torch.utils import retrace
    exp, surface = _fd_exporter()
    fetcher = BpfmanFetcher(kmaps.dir, drain_lanes=KD_LANES,
                            native_pipeline=fused)
    try:
        if fused:
            fetcher.bind_pack_surface(surface)
        captures0 = [c.captures for c in exp.captures]
        retraces0 = retrace.total_retraces()
        torch.cuda.synchronize()
        for sp in specs:
            sp["kernel"].launches = 0
        folds0 = exp.folds
        half = len(evictions) // 2
        secs, fill_s, rows, paths = [0.0, 0.0], 0.0, [0, 0], []
        native, chain = {}, {"merge_s": 0.0, "align_s": 0.0, "decode_s": 0.0}
        prof = None
        for i, maps in enumerate(evictions):
            part = int(i >= half)
            if i == half:
                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.__enter__()
            fill_s += kmaps.fill(maps)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev = fetcher.lookup_and_delete()
            exp.export_evicted(ev)
            torch.cuda.synchronize()
            secs[part] += time.perf_counter() - t0
            rows[part] += len(ev)
            st = ev.decode_stats
            paths.append(st.get("native_path", "chain"))
            if "native" in st:
                for k, v in st["native"].items():
                    native[k] = native.get(k, 0.0) + v
            else:
                for k in chain:
                    chain[k] += st[k]
        prof.__exit__(None, None, None)
        dev = _device_rows(prof)
        check(dev, "the profiler saw no device time")
        busy = sum(r[0] for r in dev) / 1e6 / secs[1]
        with exp._lock:
            exp._drain_pending()
        torch.cuda.synchronize()
        launches = {sp["name"]: sp["kernel"].launches for sp in specs}
        folds = exp.folds - folds0
        check(launches == _want_launches(specs, "lanes", folds),
              f"real maps, fused={fused}: launches {launches} for "
              f"{folds} folds")
        check([c.captures for c in exp.captures] == captures0
              and retrace.total_retraces() == retraces0,
              f"real maps, fused={fused}: a capture or a retrace")
        check(exp.records == sum(rows) and exp.ingest_errors == 0,
              f"real maps: {exp.records} records folded of {sum(rows)}")
        gate = fetcher._native_gate
        if fused:
            check(gate is not None and gate._pipe is not None
                  and not gate.disabled
                  and paths == ["chain"] + ["fused"] * (len(paths) - 1),
                  f"the fused gate did not stay engaged: {paths}")
        else:
            check(gate is None and set(paths) == {"chain"},
                  f"the raw fetcher ran {set(paths)}")
        per = BATCH / sum(rows) * 1e3
        return {"records_per_s": [r / t for r, t in zip(rows, secs)],
                "rows": rows, "drain_export_s": secs,
                "fill_ms_per_16384": fill_s * per,
                "device_busy_share_second_half": busy,
                "host_ms_per_16384": (
                    {k[:-2]: v * per for k, v in native.items()} if fused
                    else {k[:-2]: v * per for k, v in chain.items()}),
                "drain_lanes": fetcher._drain_lanes, "folds": folds,
                "launches": launches, "paths": paths[:2]}
    finally:
        fetcher.close()
        exp.close()


def _kd_checked(kmaps, evictions: list) -> dict:
    """The checked run: a fused exporter fed the fused fetcher's drains and
    a raw twin fed the raw fetcher's drains of the same contents, in lock
    step (`_fd_checked`'s order: every pending row folded before a fused
    drain packs, and after a shipped arena); each fused drain's events and
    features byte for byte against the raw drain's, and each half's
    tables bit for bit."""
    import numpy as np
    import torch
    from netobserv_tpu_torch.datapath.loader import BpfmanFetcher
    from netobserv_tpu_torch.sketch import state as sk
    fexp, surface = _fd_exporter()
    twin, _ts = _fd_exporter()
    ffetch = rfetch = None
    out = {"drains_checked": 0, "windows_bit_equal": 0, "fused_drains": 0}
    try:
        ffetch = BpfmanFetcher(kmaps.dir, drain_lanes=KD_LANES,
                               native_pipeline=True)
        rfetch = BpfmanFetcher(kmaps.dir, drain_lanes=KD_LANES)
        ffetch.bind_pack_surface(surface)

        def drain_both():
            for x in (fexp, twin):
                with x._lock:
                    x._drain_pending()

        half = len(evictions) // 2
        for i, maps in enumerate(evictions):
            if i and len(fexp.pending):
                drain_both()
            kmaps.fill(maps)
            ev = ffetch.lookup_and_delete()
            kmaps.fill(maps)
            want = rfetch.lookup_and_delete()
            check(ev.events.tobytes() == want.events.tobytes()
                  and all(getattr(ev, k).tobytes()
                          == getattr(want, k).tobytes() for k in FD_KINDS),
                  "a fused drain of real maps differs from the raw drain")
            out["drains_checked"] += 1
            out["fused_drains"] += ev.decode_stats["native_path"] == "fused"
            shipped = ev.packed is not None and \
                ev.packed.epoch == surface.epoch
            twin.export_evicted(want)
            if shipped:
                with twin._lock:
                    twin._drain_pending()
            fexp.export_evicted(ev)
            if i + 1 in (half, len(evictions)):
                drain_both()
                got, exp_t = (sk.state_tables(x.state) for x in (fexp, twin))
                diff = [k for k in exp_t
                        if not np.array_equal(got[k], exp_t[k])]
                check(not diff, f"real maps: tables {diff} differ from "
                      "the raw twin's")
                check(fexp.records == twin.records, "records differ")
                out["windows_bit_equal"] += 1
                fexp.roll()
                twin.roll()
        torch.cuda.synchronize()
        check(out["fused_drains"] == len(evictions) - 1,
              f"{out['fused_drains']} fused drains of {len(evictions)}")
        check(fexp.ingest_errors == twin.ingest_errors == 0,
              "ingest errors")
        return out
    finally:
        for f in (ffetch, rfetch):
            if f is not None:
                f.close()
        fexp.close()
        twin.close()


def _kd_live() -> dict:
    """Part 3: `MinimalKernelFetcher` (the port's bytecode through the
    kernel verifier; DNS on, so that it has a feature map and
    EVICT_NATIVE_PIPELINE a gate) attached by TCX to the loopback device
    on both directions; KD_LIVE_PER_PORT datagrams to each of
    KD_LIVE_PORTS on 127.0.0.1; the drains into a lanes exporter on the
    card. Every flow's packets and bytes as sent, counted once a pass of
    a hook on its first-seen interface (both hooks are on the loopback
    device: twice a datagram)."""
    import socket
    import numpy as np
    import torch
    from netobserv_tpu_torch.datapath.loader import MinimalKernelFetcher
    lo = socket.if_nametoindex("lo")
    exp, surface = _fd_exporter()
    fetcher = None
    try:
        fetcher = MinimalKernelFetcher(cache_max_flows=4096,
                                       attach_mode="tcx", enable_dns=True,
                                       native_pipeline=True)
        fetcher.bind_pack_surface(surface)
        fetcher.attach(lo, "lo", "both")
        kinds = {a.kind for a in fetcher._attached[("", lo)][1].values()}
        check(kinds == {"tcx"}, f"attached as {kinds}")
        first = fetcher.lookup_and_delete()  # the gate's probe drain
        exp.export_evicted(first)
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", KD_LIVE_SPORT))
        try:
            for port in KD_LIVE_PORTS:
                for _ in range(KD_LIVE_PER_PORT):
                    s.sendto(b"z" * KD_LIVE_PAYLOAD, ("127.0.0.1", port))
        finally:
            s.close()
        time.sleep(0.3)
        ev = fetcher.lookup_and_delete()
        check(ev.decode_stats.get("native_path") == "fused",
              f"the live drain ran {ev.decode_stats.get('native_path')}")
        k, st = ev.events["key"], ev.events["stats"]
        mine = (k["proto"] == 17) & (k["src_port"] == KD_LIVE_SPORT)
        ports = sorted(int(p) for p in k["dst_port"][mine])
        check(ports == list(KD_LIVE_PORTS),
              f"{len(ports)} flows captured of {len(KD_LIVE_PORTS)}")
        want_pkts = 2 * KD_LIVE_PER_PORT
        want_bytes = want_pkts * (KD_LIVE_PAYLOAD + 42)
        check(bool(np.all(st["packets"][mine] == want_pkts)
                   and np.all(st["bytes"][mine] == want_bytes)
                   and np.all(st["n_observed_intf"][mine] == 1)
                   and np.all(st["if_index_first"][mine] == lo)),
              "a captured flow's packets or bytes differ from those sent")
        exp.export_evicted(ev)
        with exp._lock:
            exp._drain_pending()
        torch.cuda.synchronize()
        report = exp.roll()
        rep = report if isinstance(report, dict) else report[0]
        check(rep["Records"] == len(first) + len(ev)
              and exp.ingest_errors == 0,
              f"the window folded {rep['Records']} of "
              f"{len(first) + len(ev)} records")
        return {"flows": len(ports), "packets_per_flow": want_pkts,
                "bytes_per_flow": want_bytes, "evicted_rows": len(ev),
                "other_rows": int((~mine).sum()), "attach": "tcx",
                "window_records": rep["Records"]}
    finally:
        if fetcher is not None:
            fetcher.close()
        exp.close()


def phase_kernel_datapath(specs, events, card: str,
                          injected: dict | None = None) -> dict:
    """The kernel datapath's programs and its bpf(2) layer (module
    docstring, `kernel_datapath`); `injected` is this run's fused_drain
    fused run, whose figures over injected maps print beside the real
    maps'."""
    import os
    import shutil
    from netobserv_tpu_torch.datapath import kernel
    t0 = time.perf_counter()
    out = {"phase": "kernel_datapath", "card": card,
           "programs": _kd_builders(), "parts_run": ["builders"],
           "skipped": {}}
    emit({"phase": "kernel_datapath_builders",
          "programs": out.pop("programs")})
    why = _kd_probe_bpf()
    if why is not None:
        print(f"kernel_datapath: real maps and live capture skipped: {why}",
              flush=True)
        out["skipped"]["real_maps"] = out["skipped"]["live_capture"] = why
    else:
        kmaps = _KdMaps()
        try:
            evictions = _kd_evictions(events, kmaps.n_cpus)
            plains: dict = {}
            with counting_plains(specs, plains):
                fused = _kd_timed(specs, kmaps, evictions, fused=True)
                raw = _kd_timed(specs, kmaps, evictions, fused=False)
                checked = _kd_checked(kmaps, evictions)
            check(not plains, f"real maps: plain versions ran {plains}")
        finally:
            kmaps.close()
        check(not os.path.exists(kmaps.dir), "the pin directory remains")
        out["parts_run"].append("real_maps")
        out.update({"n_possible_cpus": kmaps.n_cpus,
                    "evictions": len(evictions),
                    "eviction_keys": [len(m[0][0]) for m in evictions],
                    "fused": fused, "raw": raw, "checks": checked,
                    "launches": fused["launches"],
                    "raw_launches": raw["launches"],
                    "injected_maps": None if injected is None else {
                        "host_ms_per_16384": injected["host_ms_per_16384"],
                        "records_per_s": injected["records_per_s"],
                        "device_busy_share_window1":
                            injected["device_busy_share_window1"]}})
        live_why = ("not root" if os.geteuid() != 0 else
                    "no tc" if shutil.which("tc") is None else
                    None if kernel.supports_tcx() else
                    f"no tcx (kernel {kernel.current_release()})")
        if live_why is not None:
            print(f"kernel_datapath: live capture skipped: {live_why}",
                  flush=True)
            out["skipped"]["live_capture"] = live_why
        else:
            plains = {}
            with counting_plains(specs, plains):
                out["live"] = _kd_live()
            check(not plains, f"live capture: plain versions ran {plains}")
            out["parts_run"].append("live_capture")
    out["seconds"] = time.perf_counter() - t0
    return out


#: bpf(2) command of a batched map update (uapi/linux/bpf.h)
BPF_MAP_UPDATE_BATCH = 26


def bpf_update_batch(bmap, keys, vals) -> None:
    """Write n entries into a real map in one BPF_MAP_UPDATE_BATCH call:
    keys (n, key_size) u8, vals (n, n_cpus) records of the map's value
    size (each CPU's record padded to the kernel's 8-byte stride for a
    per-CPU map). A later duplicate key overwrites an earlier one, as
    the kernel applies the entries in order."""
    import struct
    import numpy as np
    from netobserv_tpu_torch.datapath import syscall_bpf as sb
    keys = np.ascontiguousarray(keys, np.uint8)
    n, vs = len(keys), bmap.value_size
    if (keys.ndim != 2 or keys.shape[1] != bmap.key_size or len(vals) != n
            or vals.shape[1:] != (bmap.n_cpus,)
            or vals.dtype.itemsize != vs):
        raise ValueError(
            f"keys {keys.shape} / values {vals.shape} of {vals.dtype.itemsize}"
            f" B do not fit a map of key {bmap.key_size} B, value {vs} B "
            f"at {bmap.n_cpus} CPUs")
    if not n:
        return
    pad = (vs + 7) & ~7 if bmap.percpu else vs
    buf = np.zeros((n, bmap.n_cpus, pad), np.uint8)
    buf[:, :, :vs] = np.ascontiguousarray(vals).view(np.uint8).reshape(
        n, bmap.n_cpus, vs)
    attr = bytearray(struct.pack(
        "=QQQQIIQQ", 0, 0, keys.ctypes.data, buf.ctypes.data, n, bmap.fd,
        0, 0))
    sb._bpf_inout(BPF_MAP_UPDATE_BATCH, attr)
    done = struct.unpack_from("=I", attr, 32)[0]
    if done != n:
        raise OSError(f"batched update wrote {done} of {n} entries")


#: fault C14's check on the card: integer-mass records a mode
C14_RECORDS = 20_000
C14_CHUNK = 1_000


def _record_path(specs, events, make, read) -> dict:
    """Fault C14's check: C14_RECORDS integer-mass records of the lanes
    stream through `export_batch` (C14_CHUNK a call) of the exporter
    `make(device)` builds on the card and on the CPU; the card's tables
    (`read(exp)`, after the pending records fold) bit for bit against the
    CPU's, the rolled reports' records and bytes equal, no plain version
    on the card; the card's ms per 16,384 records."""
    import numpy as np
    import torch
    from netobserv_tpu_torch.model.record import records_from_events
    ev = _integer_stream(events)[0][:C14_RECORDS]
    recs = records_from_events(ev)
    out = {}
    tables, reports = {}, {}
    for where in ("card", "cpu"):
        exp = make(where)
        plains: dict = {}
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with counting_plains(specs, plains):
                for lo in range(0, len(recs), C14_CHUNK):
                    exp.export_batch(recs[lo:lo + C14_CHUNK])
                with exp._lock, exp._on_device():
                    exp._drain_pending()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                tables[where] = read(exp)
            if where == "card":
                check(not plains, f"record path: plain versions ran {plains}")
                out["ms_per_16384"] = wall * 1e3 * BATCH / len(recs)
                out["folds"] = exp.folds
            reports[where] = exp.roll()
        finally:
            exp.close()
    a, b = tables["card"], tables["cpu"]
    diff = [k for k in b if not np.array_equal(a[k], b[k])]
    check(a.keys() == b.keys() and not diff,
          f"record path: tables {diff} differ from the CPU's")
    ra, rb = ([(r["Records"], r["Bytes"]) for r in
               (x if isinstance(x, list) else [x])] for x in
              (reports["card"], reports["cpu"]))
    check(ra == rb and sum(r for r, _ in ra) == len(recs),
          f"record path reports {ra} / {rb}")
    out.update({"records": len(recs), "tables_bit_equal_cpu": len(b),
                "bytes": float(ev["stats"]["bytes"].sum())})
    return out


def phase_window_thread(specs, universe, pool, events) -> dict:
    """The exporter's window thread at full width on the lanes path (the
    module docstring's `window_thread`): WT_SECONDS of the lanes path's
    evictions with the thread closing WINDOW_S windows and a sink of
    SINK_SLEEP_S a report, one contained dispatch failure in window
    WT_FAIL_WINDOW, then the same stream replayed eagerly with the plain
    versions, rolled after the same evictions, window held against
    window."""
    import numpy as np
    import torch
    from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    from netobserv_tpu_torch.scenarios import traffic
    from netobserv_tpu_torch.sketch import state as sk
    from netobserv_tpu_torch.utils import retrace, tracing
    try:
        from netobserv_tpu_torch.metrics.registry import Metrics
        metrics = Metrics()
    except ImportError:  # prometheus_client is optional
        metrics = None
    cfg = sk.SketchConfig()
    ev_all, lanes_all = LaneFeeder(events).stream
    n_rows = len(ev_all)
    n = len(events)
    ranks = np.concatenate([pool[i % n][1] for i in range(FOLDS_PER_WINDOW)])
    nbytes = ev_all["stats"]["bytes"].astype(np.float64)
    uni = traffic.event_universe(universe)
    index = {w.tobytes(): r for r, w in enumerate(uni)}

    def eviction(lo, hi):
        return EvictedFlows(ev_all[lo:hi],
                            **{k: v[lo:hi] for k, v in lanes_all.items()})

    # the timed run: the window thread on, captured folds, the kernels
    sink = WindowSink(SINK_SLEEP_S)
    tracing.configure(sample=1.0, capacity=1 << 14)
    retraces0 = retrace.total_retraces()
    exp = TorchSketchExporter(cfg, batch_size=BATCH, device="cuda",
                              window_s=WINDOW_S, sink=sink, metrics=metrics,
                              **LANES_KW)
    try:
        with exp._lock:
            exp._ensure_ring()  # the ladder's captures, before the clock
            ring = exp.ring
            fail = DispatchFailure(exp)
            seam = RollSeam(exp)
            rolls0 = exp.rolls
            # the first window starts with the feed, not with the ring's
            # captures
            exp._deadline = time.monotonic() + WINDOW_S
        check(rolls0 == 0, "the window thread rolled before the feed")
        captures0 = [c.captures for c in exp.captures]
        for s in specs:
            s["kernel"].launches = 0
        gen = _stream_evictions(n_rows)
        fed, samples = [], []
        t_start = time.perf_counter()
        last_open = False  # the last eviction went into the open window
        while not (time.perf_counter() - t_start >= WT_SECONDS and last_open
                   and exp._deadline - time.monotonic() >= WT_MARGIN_S):
            if fail.at is None and exp.rolls >= WT_FAIL_WINDOW:
                fail.arm_next()
            lo, hi = next(gen)
            rolls = exp.rolls
            t0 = time.perf_counter()
            exp.export_evicted(eviction(lo, hi))
            samples.append((t0, time.perf_counter() - t0))
            fed.append((lo, hi))
            last_open = exp.rolls == rolls
        torch.cuda.synchronize()
        feed_s = time.perf_counter() - t_start
        captures1 = [c.captures for c in exp.captures]
        watch = _watch_stats(exp)
        t0 = time.perf_counter()
        exp.close()
        close_s = time.perf_counter() - t0
    finally:
        tracing.configure(sample=0.0)
    kt = key_table_check(ring)  # the dictionaries and key tables outlive it
    launches = {s["name"]: s["kernel"].launches for s in specs}
    traces = [t for t in tracing.snapshot() if t["kind"] == "window"]
    rows_fed = sum(hi - lo for lo, hi in fed)
    dropped = len(fail.events) if fail.events is not None else 0

    # each report once, in order; the failure contained; no new capture
    reps = sink.reports
    check([r["Window"] for r in reps] == list(range(exp.rolls)),
          f"windows {[r['Window'] for r in reps]}, {exp.rolls} rolls")
    check(exp.reports_published == exp.rolls and exp.reports_shed == 0,
          f"{exp.reports_published} published, {exp.reports_shed} shed")
    check(exp.rolls >= WT_FAIL_WINDOW + 2, f"{exp.rolls} windows")
    check(reps[-1]["Records"] > 0, "close published no partial window")
    check(fail.fired == 1 and exp.ingest_errors == 1,
          f"{fail.fired} failures, {exp.ingest_errors} ingest errors")
    check(ring.dict_resets - fail.resets_at_raise == len(ring.kdicts),
          f"dict_resets {fail.resets_at_raise} -> {ring.dict_resets}, "
          f"{len(ring.kdicts)} dictionaries")
    check(sum(r["Records"] for r in reps) == float(rows_fed - dropped),
          f"records {sum(r['Records'] for r in reps)}, fed {rows_fed}, "
          f"dropped {dropped}")
    check(exp.records == rows_fed - dropped, f"exporter records "
          f"{exp.records}")
    check(captures1 == captures0 and retrace.total_retraces() == retraces0,
          f"captures {captures1} (was {captures0}), retraces "
          f"{retrace.total_retraces() - retraces0}")
    check(all(w["compiles"] == (1 if _warm_captured(w["fn"]) else 0)
              and w["retraces"] == 0 for w in watch),
          f"captured folds {watch}")
    want = _want_launches(specs, "lanes", exp.folds)
    check(launches == want, f"launches {launches}, want {want}")
    check(len(traces) == exp.rolls, f"{len(traces)} window traces")

    # the replay: plain versions, eager, rolled after the same evictions
    adds: dict = {}
    touched: dict = {}
    sink2 = WindowSink()
    with plain_versions(specs, adds, touched):
        exp2 = TorchSketchExporter(cfg, batch_size=BATCH, device="cuda",
                                   capture=False, sink=sink2, **LANES_KW)
        with exp2._lock:
            exp2._ensure_ring()
        fail2 = DispatchFailure(exp2, at=fail.at)
        seam2 = RollSeam(exp2, adds, touched)
        at = [a for a, _, _ in seam.rolls]
        j = 0
        for i, (lo, hi) in enumerate(fed):
            while j < len(at) - 1 and at[j] == i:
                exp2.roll()
                j += 1
            exp2.export_evicted(eviction(lo, hi))
        while j < len(at) - 1:
            exp2.roll()
            j += 1
        exp2.close()  # the last roll, as close made it on the timed run
    check(fail2.fired == 1 and exp2.ingest_errors == 1
          and len(fail2.events) == dropped and fail2.window == fail.window
          and fail.window == WT_FAIL_WINDOW, "the replay failed otherwise")
    check(len(sink2.reports) == len(reps), f"{len(sink2.reports)} replayed "
          f"reports, {len(reps)} timed")
    cmp, recalls = [], []
    bounds = [0] + at
    for w, (rep, rep2) in enumerate(zip(reps, sink2.reports)):
        check(rep["Records"] == rep2["Records"]
              and rep["Bytes"] == rep2["Bytes"],
              f"window {w}: records {rep['Records']} / {rep2['Records']}, "
              f"bytes {rep['Bytes']} / {rep2['Bytes']}")
        tables = sk.state_tables(seam.rolls[w][1])
        tables2 = sk.state_tables(seam2.rolls[w][1])
        cmp.append(compare_tables(tables, tables2, seam2.rolls[w][2]))
        if rep["Records"] >= BATCH:
            recalls.append(_window_recall(
                tables["heavy_words"], tables["heavy_valid"],
                fed[bounds[w]:bounds[w + 1]], ranks, nbytes, uni,
                dropped=fail.events if w == fail.window else None,
                index=index))
    check(recalls and min(recalls) >= 0.99, f"recall@100 {recalls}")

    dts = [dt for _, dt in samples]
    during = [dt for t, dt in samples
              if any(a <= t <= b for a, b in sink.spans)]

    def span(t, name):
        return sum(s["dur_ms"] for s in t["stages"] if s["stage"] == name)

    traces.sort(key=lambda t: t["start_unix_ms"])
    return {"phase": "window_thread", "window_s": WINDOW_S,
            "sink_sleep_s": SINK_SLEEP_S, "registry": metrics is not None,
            "tracing_sample": 1.0, "feed_seconds": feed_s,
            "evictions": len(fed), "records_fed": rows_fed,
            "records_per_s": rows_fed / feed_s,
            "export_evicted_max_s": max(dts),
            "export_evicted_median_s": float(np.median(dts)),
            "export_evicted_max_during_sink_s": max(during, default=None),
            "evictions_during_sink": len(during),
            "close_seconds": close_s,
            "roll_drain_ms": [span(t, "roll_drain") for t in traces],
            "roll_dispatch_ms": [span(t, "roll_dispatch") for t in traces],
            "report_render_ms": [span(t, "report_render") for t in traces],
            "report_sink_ms": [span(t, "report_sink") for t in traces],
            "windows": exp.rolls, "reports_published": exp.reports_published,
            "reports_shed": exp.reports_shed, "folds": exp.folds,
            "ingest_errors": exp.ingest_errors, "dropped_records": dropped,
            "failed_fold_call": fail.at, "failed_window": fail.window,
            "dict_resets": ring.dict_resets,
            "records_per_window": [r["Records"] for r in reps],
            "superbatch_folds": {str(k): v for k, v in
                                 sorted(ring.superbatch_folds.items())},
            "launches": launches, "key_table": kt,
            "recall_at_100": recalls, "vs_plain_replay": cmp}


#: the query_plane phase: its window, twice window_thread's (under the
#: pollers' tight loop a fold can take most of a second, and a 0.5 s window
#: once saw its only refresh slot pass while one ran), the mid-window
#: refresh period (a quarter of the window), the poller threads and the
#: closed windows the ring keeps
QP_WINDOW_S = 1.0
QP_REFRESH_S = QP_WINDOW_S / 4
QP_POLLERS = 4
QP_HISTORY = 8
#: seconds each poller waits after asking every route once (0: a tight
#: loop; `scripts/query_plane_load.py` sets others)
QP_PACE_S = 0.0
#: the routes the pollers ask, in turn; "window" is a `?window=` read of
#: a closed window (the pollers step it back 1-10 windows, so past 8 it
#: reads an evicted one)
QP_ROUTES = ("topk", "frequency", "cardinality", "victims", "churn",
             "status", "alerts", "window", "executables")
#: the routes that read the published snapshot (ordered by window and seq)
QP_SNAPSHOT_ROUTES = ("topk", "frequency", "cardinality", "victims", "churn",
                      "status")


class TimedLock:
    """An exporter's lock, each hold timed while the holding thread runs a
    mid-window refresh (`refresh_on`/`refresh_off`)."""

    def __init__(self, lock):
        import threading
        self._lock = lock
        self._local = threading.local()
        self.holds: list = []  # seconds of each hold a refresh made

    def refresh_on(self) -> int:
        self._local.refresh = True
        return len(self.holds)

    def refresh_off(self) -> None:
        self._local.refresh = False

    def refreshing(self) -> bool:
        return getattr(self._local, "refresh", False)

    def __enter__(self):
        self._lock.acquire()
        self._local.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._local.t0
        self._lock.release()
        if self.refreshing():
            self.holds.append(dt)
        return False


def _five_tuple(words) -> dict:
    """The /query/frequency parameters naming a key of key words."""
    import numpy as np
    from netobserv_tpu_torch.model.columnar import unpack_key_words
    from netobserv_tpu_torch.model.flow import ip_from_16
    k = unpack_key_words(np.asarray(words, np.uint32).reshape(1, -1))[0]
    return {"src": ip_from_16(k["src_ip"].tobytes()),
            "dst": ip_from_16(k["dst_ip"].tobytes()),
            "src_port": str(int(k["src_port"])),
            "dst_port": str(int(k["dst_port"])),
            "proto": str(int(k["proto"]))}


def _poll(base: str, debug: str, key: dict, idx: int, stop,
          answers: list, pace: float = 0.0) -> None:
    """One poller: asks QP_ROUTES in turn until `stop`, waiting `pace`
    seconds after each turn, keeping each answer's (route, send and receive
    times on the monotonic clock, status, window, seq, the `?window=`
    asked) in order."""
    import json as _json
    import urllib.error
    import urllib.parse
    import urllib.request
    freq = urllib.parse.urlencode(key)
    back = idx % 10
    last_window = 0
    while not stop.is_set():
        for route in QP_ROUTES:
            wid = None
            if route == "executables":
                url = f"{debug}/debug/executables"
            elif route == "window":
                back = back % 10 + 1
                wid = last_window - back
                url = f"{base}/query/topk?n=10&window={wid}"
            elif route == "frequency":
                url = f"{base}/query/frequency?{freq}"
            else:
                url = f"{base}/query/{route}"
            t0 = time.monotonic()
            try:
                with urllib.request.urlopen(url, timeout=10) as resp:
                    code, body = resp.status, resp.read()
            except urllib.error.HTTPError as err:
                code, body = err.code, err.read()
            t1 = time.monotonic()
            window = seq = None
            if code == 200 and route != "executables":
                obj = _json.loads(body)
                window, seq = obj.get("window"), obj.get("seq")
                if route in QP_SNAPSHOT_ROUTES and window is not None:
                    last_window = max(last_window, int(window))
            answers.append((route, t0, t1, code, window, seq, wid))
        stop.wait(pace)


def poll_main(argv) -> int:
    """`chip_smoke.py --poll BASE DEBUG KEY_JSON N PACE`: the query_plane
    phase's pollers, N threads of `_poll` in a process of their own (so
    their client work does not share the exporter's interpreter lock, as a
    dashboard's would not), until standard input closes; then each
    poller's answers as one JSON line."""
    import threading
    base, debug, key, n = argv[0], argv[1], json.loads(argv[2]), int(argv[3])
    pace = float(argv[4])
    stop = threading.Event()
    answered: list = [[] for _ in range(n)]
    threads = [threading.Thread(target=_poll, args=(base, debug, key, i,
                                                    stop, answered[i], pace))
               for i in range(n)]
    for t in threads:
        t.start()
    sys.stdin.read()
    stop.set()
    for t in threads:
        t.join()
    print(json.dumps(answered), flush=True)
    return 0


def phase_query_plane(specs, universe, pool, events, wt_records_per_s
                      ) -> dict:
    """The query plane at full width on the lanes path (the module
    docstring's `query_plane`): the window thread with its mid-window
    refresh, an alert engine, the metrics and debug servers and four
    pollers (`poll_main`), fed the lanes path's evictions for about
    WT_SECONDS."""
    import logging
    import os
    import numpy as np
    import torch
    from netobserv_tpu_torch.alerts import engine as aengine
    from netobserv_tpu_torch.alerts import rules as arules
    from netobserv_tpu_torch.alerts import sinks as asinks
    from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    from netobserv_tpu_torch.scenarios import traffic
    from netobserv_tpu_torch.server.debug import start_debug_server
    from netobserv_tpu_torch.sketch import state as sk
    from netobserv_tpu_torch.utils import retrace
    try:
        from netobserv_tpu_torch.metrics.registry import Metrics
        metrics = Metrics()
    except ImportError:  # prometheus_client is optional
        metrics = None
    cfg = sk.SketchConfig()
    ev_all, lanes_all = LaneFeeder(events).stream
    # a 5-tuple names a key with no ICMP type or code (the query surface's
    # key form); the bench universe draws them at random
    ev_all = ev_all.copy()
    ev_all["key"]["icmp_type"] = 0
    ev_all["key"]["icmp_code"] = 0
    n_rows = len(ev_all)
    n = len(events)
    ranks = np.concatenate([pool[i % n][1] for i in range(FOLDS_PER_WINDOW)])
    nbytes = ev_all["stats"]["bytes"].astype(np.float64)
    uni = traffic.event_universe(universe)
    uni[:, 9] &= np.uint32(0x00FF0000)
    stream_top = int(np.argmax(np.bincount(ranks, weights=nbytes,
                                           minlength=len(uni))))
    key = _five_tuple(uni[stream_top])

    def eviction(lo, hi):
        return EvictedFlows(ev_all[lo:hi],
                            **{k: v[lo:hi] for k, v in lanes_all.items()})

    # the log sink's transitions, counted here rather than printed
    alert_log = logging.getLogger("netobserv_tpu_torch.alerts")
    logged = []

    class _Count(logging.Handler):
        def emit(self, record):
            logged.append(record.getMessage())
    handler = _Count()
    alert_log.addHandler(handler)
    alert_log.propagate = False
    engine = aengine.AlertEngine(arules.default_rules(), metrics=metrics,
                                 sinks=[asinks.LogSink()],
                                 history=QP_HISTORY)
    sink = WindowSink()
    plain_calls: dict = {}
    copies: list = []  # (the live state's, seconds) of each CM-plane copy
    real_planes = sk.host_cm_planes
    retraces0 = retrace.total_retraces()
    srv = dbg = proc = None
    try:
        with counting_plains(specs, plain_calls):
            exp = TorchSketchExporter(
                cfg, batch_size=BATCH, device="cuda", window_s=QP_WINDOW_S,
                sink=sink, metrics=metrics, query_refresh_s=QP_REFRESH_S,
                query_history=QP_HISTORY, alerts=engine, agent_id="smoke",
                **LANES_KW)

            def timed_planes(state):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                planes = real_planes(state)
                copies.append((state is exp.state,
                               time.perf_counter() - t0))
                return planes
            sk.host_cm_planes = timed_planes
            lock = exp._lock = TimedLock(exp._lock)
            refreshes: list = []  # (start, end, seconds under the lock)
            real_refresh = exp._refresh_query_snapshot

            def refresh():
                first = lock.refresh_on()
                t0 = time.monotonic()
                try:
                    real_refresh()
                finally:
                    lock.refresh_off()
                    refreshes.append((t0, time.monotonic(),
                                      sum(lock.holds[first:])))
            exp._refresh_query_snapshot = refresh
            drains: list = []  # seconds of the pending drain of a refresh
            real_drain = exp._drain_pending

            def drain():
                t0 = time.perf_counter()
                real_drain()
                if lock.refreshing():
                    drains.append(time.perf_counter() - t0)
            exp._drain_pending = drain
            pubs: list = []  # (time, window, seq, mid, Records, Bytes, rows)
            real_publish = exp.query.publish

            def publish(snap, mid_window=False):
                seq = real_publish(snap, mid_window)
                rep = snap["report"]
                pubs.append((time.monotonic(), snap["window"], seq,
                             mid_window, rep["Records"], rep["Bytes"],
                             snap["cm_bytes"].astype(np.float64).sum(axis=1)))
                return seq
            exp.query.publish = publish
            with exp._lock:
                exp._ensure_ring()  # the ladder's captures, before the clock
                ring = exp.ring
                seam = RollSeam(exp, keep_state=False)
                exp._deadline = time.monotonic() + QP_WINDOW_S
            srv = exp.serve()
            dbg = start_debug_server("127.0.0.1:0")
            base = f"http://127.0.0.1:{srv.server_address[1]}"
            debug = f"http://127.0.0.1:{dbg.server_address[1]}"
            captures0 = [c.captures for c in exp.captures]
            for s in specs:
                s["kernel"].launches = 0
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--poll", base,
                 debug, json.dumps(key), str(QP_POLLERS), str(QP_PACE_S)],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
            t_start = time.perf_counter()
            gen = _stream_evictions(n_rows)
            fed, samples = [], []
            while time.perf_counter() - t_start < WT_SECONDS:
                lo, hi = next(gen)
                t0 = time.monotonic()
                exp.export_evicted(eviction(lo, hi))
                samples.append((t0, time.monotonic() - t0))
                fed.append((lo, hi))
            torch.cuda.synchronize()
            feed_s = time.perf_counter() - t_start
            answered = json.loads(proc.communicate("", timeout=60)[0])
            check(proc.returncode == 0 and len(answered) == QP_POLLERS,
                  f"pollers exited {proc.returncode}")
            # under the lock: the window thread's timer close folds the
            # pending rows under it, launching before it counts the fold
            with exp._lock:
                launches = {s["name"]: s["kernel"].launches for s in specs}
                folds = exp.folds
            captures1 = [c.captures for c in exp.captures]
            watch = _watch_stats(exp)
            # a refresh with the folds paused (no feed, no close due)
            with exp._lock:
                exp._deadline = None
                exp._drain_pending()
            live0 = exp.state_tables()
            refresh()
            live1 = exp.state_tables()
            paused_identical = all(np.array_equal(live0[k], live1[k])
                                   for k in live0)
            metrics_code = None
            if metrics is not None:
                import urllib.request
                with urllib.request.urlopen(f"{base}/metrics",
                                            timeout=10) as resp:
                    metrics_code = resp.status
            exp.close()
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        sk.host_cm_planes = real_planes
        alert_log.removeHandler(handler)
        alert_log.propagate = True
        for server in (srv, dbg):
            if server is not None:
                server.shutdown()
                server.server_close()
    check(not plain_calls, f"plain versions ran on the card: {plain_calls}")
    check(paused_identical, "a refresh with the folds paused changed the "
          "live tables")

    # reports and the window plane, as window_thread holds them
    reps = sink.reports
    check([r["Window"] for r in reps] == list(range(exp.rolls)),
          f"windows {[r['Window'] for r in reps]}, {exp.rolls} rolls")
    check(exp.reports_published == exp.rolls and exp.reports_shed == 0
          and exp.ingest_errors == 0 and exp.rolls >= 3,
          f"{exp.rolls} rolls, {exp.reports_published} published, "
          f"{exp.reports_shed} shed, {exp.ingest_errors} ingest errors")
    check(captures1 == captures0 and retrace.total_retraces() == retraces0,
          f"captures {captures1} (was {captures0}), retraces "
          f"{retrace.total_retraces() - retraces0}")
    check(all(w["compiles"] == (1 if _warm_captured(w["fn"]) else 0)
              and w["retraces"] == 0 for w in watch),
          f"captured folds {watch}")
    want = _want_launches(specs, "lanes", folds)
    check(launches == want, f"launches {launches}, want {want}")

    # the snapshots: every window one closed snapshot and (closed by the
    # timer) a mid-window one before it; seq rising
    check([p[2] for p in pubs] == list(range(1, len(pubs) + 1)),
          "publish sequence")
    closed = {p[1]: p for p in pubs if not p[3]}
    check(sorted(closed) == list(range(exp.rolls))
          and len(closed) == sum(1 for p in pubs if not p[3]),
          f"closed snapshots {sorted(closed)}")
    mids = {w: sum(1 for p in pubs if p[3] and p[1] == w)
            for w in range(exp.rolls)}
    check(all(mids[w] >= 1 for w in range(exp.rolls - 1)),
          f"mid-window snapshots per window {mids}")
    at = [a for a, _, _ in seam.rolls]
    bounds = [0] + at
    exact_rows, worst = [], 0.0
    check(len(at) == exp.rolls, f"{len(at)} rolls seen, {exp.rolls} made")
    for w in range(exp.rolls):
        ev_w = fed[bounds[w]:bounds[w + 1]]
        rows = sum(hi - lo for lo, hi in ev_w)
        byts = sum(float(nbytes[lo:hi].sum()) for lo, hi in ev_w)
        _, _, _, _, recs, b, row_sums = closed[w]
        tol = 2 * max(rows, 1) * U
        check(recs == float(rows), f"window {w}: Records {recs}, fed {rows}")
        check(abs(b - byts) <= tol * byts,
              f"window {w}: Bytes {b}, fed {byts}")
        rel = [abs(r - b) / max(b, 1.0) for r in row_sums]
        check(max(rel) <= tol, f"window {w}: CM row sums {row_sums} "
              f"against Bytes {b}")
        worst = max(worst, max(rel))
        exact_rows.append(rows)

    # /query/frequency on each closed window still in the ring, for the
    # window's exact top key
    freq = []
    for w in exp.query.windows():
        totals = np.zeros(len(uni))
        for lo, hi in fed[bounds[w]:bounds[w + 1]]:
            totals += np.bincount(ranks[lo:hi], weights=nbytes[lo:hi],
                                  minlength=len(uni))
        top = int(np.argmax(totals))
        code, body = exp.query_routes.handle(
            "/query/frequency", {**_five_tuple(uni[top]), "window": str(w)})
        b = closed[w][5]
        slack = 2 * max(exact_rows[w], 1) * U * b
        check(code == 200 and body["est_bytes"] >= totals[top] - slack,
              f"window {w}: frequency {code} {body}, exact {totals[top]}")
        freq.append({"window": w, "top_is_stream_top": top == stream_top,
                     "exact_bytes": float(totals[top]),
                     "est_bytes": body["est_bytes"],
                     "bound_bytes": body["overestimate_bound_bytes"]})

    # the pollers' answers: each status allowed, and (window, seq) of the
    # snapshot routes, and of the alert view, never going back in a poller
    first_pub = pubs[0][0] if pubs else float("inf")
    answers = [a for one in answered for a in one]
    codes: dict = {}
    for route, t0, t1, code, window, seq, wid in answers:
        codes.setdefault(route, {}).setdefault(code, 0)
        codes[route][code] += 1
        if route in QP_SNAPSHOT_ROUTES:
            ok = code == 200 or (code == 503 and t0 < first_pub
                                 and route != "status")
        elif route == "window":
            latest = max((p[1] for p in pubs if not p[3] and p[0] <= t1),
                         default=-1)
            ok = (code == 200 and window == wid) or (
                code == 404 and (wid < 0 or wid <= latest - QP_HISTORY))
        else:
            ok = code == 200
        check(ok, f"{route}: {code} (window {wid}) at {t0 - first_pub:.3f} "
              "s from the first publish")
    for one in answered:
        last = {"snapshot": (-1, -1), "alerts": (-1, -1)}
        for route, _, _, code, window, seq, _ in one:
            kind = ("snapshot" if route in QP_SNAPSHOT_ROUTES else
                    "alerts" if route == "alerts" else None)
            if kind is None or code != 200 or window is None:
                continue
            cur = (int(window), int(seq))
            check(cur >= last[kind], f"{route}: (window, seq) {cur} after "
                  f"{last[kind]}")
            last[kind] = cur
    # latency from each poller's second turn on: its first turn holds the
    # connection's and both processes' first-use costs
    turn = len(QP_ROUTES)
    lat = {r: sorted(t1 - t0 for one in answered
                     for rr, t0, t1, *_ in one[turn:] if rr == r)
           for r in QP_ROUTES}
    first_turn = [t1 - t0 for one in answered for _, t0, t1, *_ in one[:turn]]
    check(all(lat[r] for r in QP_ROUTES), "a route was never asked")
    holds = [h for _, _, h in refreshes]
    totals_ms = [1e3 * (t1 - t0) for t0, t1, _ in refreshes]
    during = [dt for t, dt in samples
              if any(a <= t + dt and t <= b for a, b, _ in refreshes)]
    roll_copies = [1e3 * s for live, s in copies if live]
    dts = [dt for _, dt in samples]
    rows_fed = sum(hi - lo for lo, hi in fed)

    def pct(v, q):
        return 1e3 * float(np.percentile(v, q))
    return {"phase": "query_plane", "window_s": QP_WINDOW_S,
            "refresh_s": QP_REFRESH_S, "history": QP_HISTORY,
            "pollers": QP_POLLERS, "poll_pace_s": QP_PACE_S,
            "registry": metrics is not None,
            "metrics_route": metrics_code, "feed_seconds": feed_s,
            "evictions": len(fed), "records_fed": rows_fed,
            "records_per_s": rows_fed / feed_s,
            "window_thread_records_per_s": wt_records_per_s,
            "windows": exp.rolls, "folds": folds, "launches": launches,
            "snapshots": len(pubs), "mid_window_snapshots": mids,
            "refreshes": len(refreshes),
            "refresh_lock_ms_median": 1e3 * float(np.median(holds)),
            "refresh_lock_ms_max": 1e3 * max(holds),
            "refresh_drain_ms_median": 1e3 * float(np.median(drains)),
            "refresh_drain_ms_max": 1e3 * max(drains),
            "refresh_total_ms_median": float(np.median(totals_ms)),
            "refresh_total_ms_max": max(totals_ms),
            "roll_cm_copy_ms_median": float(np.median(roll_copies)),
            "roll_cm_copy_ms_max": max(roll_copies),
            "roll_cm_copy_mib": 2 * cfg.cm_depth * cfg.cm_width * 4 / 2**20,
            "export_evicted_max_s": max(dts),
            "export_evicted_median_s": float(np.median(dts)),
            "export_evicted_max_during_refresh_s": max(during, default=None),
            "evictions_during_refresh": len(during),
            "route_ms": {r: {"p50": pct(v, 50), "p99": pct(v, 99),
                             "n": len(v)} for r, v in lat.items()},
            "first_turn_ms_max": 1e3 * max(first_turn),
            "route_codes": {r: {str(c): k for c, k in sorted(v.items())}
                            for r, v in codes.items()},
            "cm_row_sum_worst_rel": worst, "frequency": freq,
            "alert_transitions_logged": len(logged),
            "alerts": engine.summary(),
            "paused_refresh_identical": paused_identical}


#: the federation phase: live agents, the sources a fan-in window sends
#: (each live agent's frame under FED_IDS ids), its fan-in windows, and
#: the roll-cost comparison's empty windows per agent and mode
FED_AGENTS = 4
FED_IDS = 64
FED_FANIN_WINDOWS = 2
FED_ROLL_PAIRS = 3
#: the tables of a frame, by how the aggregator merges them
FED_ADDED = ("cm_bytes", "cm_pkts", "hist_rtt", "hist_dns", "ddos_rate",
             "syn_rate", "synack", "drops_rate", "drop_causes", "dscp_bytes",
             "conv_fwd", "conv_rev", "scalars")
FED_MAXED = ("hll_src", "hll_per_dst", "hll_per_src")


class FrameTap:
    """An agent's delta sink: hands each frame to the aggregator's
    `ingest_frame`, and keeps the frame, its ack and the ingest's wall
    seconds."""

    def __init__(self, agg):
        self.agg = agg
        self.frames: list = []
        self.acks: list = []
        self.seconds: list = []

    def __call__(self, frame: bytes):
        t0 = time.perf_counter()
        ack = self.agg.ingest_frame(frame)
        self.seconds.append(time.perf_counter() - t0)
        self.frames.append(frame)
        self.acks.append(ack)
        return ack


def _pct(xs, q: float):
    import numpy as np
    return float(np.percentile(xs, q)) if len(xs) else None


def _span_ms(trace: dict, name: str) -> float:
    return sum(s["dur_ms"] for s in trace["stages"] if s["stage"] == name)


def _agent_quarters(events):
    """Each agent's seeded quarter of the lanes path's stream (one window
    of the pool, as every path's), as its rows in order."""
    return _agent_quarters_of(LaneFeeder(events).stream)


def _agent_quarters_of(stream):
    """`_agent_quarters` of an (events, lanes) stream."""
    import numpy as np
    ev, lanes = stream
    owner = np.random.default_rng(13).integers(0, FED_AGENTS, len(ev))
    return [(ev[owner == a], {k: v[owner == a] for k, v in lanes.items()})
            for a in range(FED_AGENTS)]


def _evict(exp, part, rng) -> int:
    """Deliver a quarter as evictions of the lanes path's sizes."""
    from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
    ev, lanes = part
    lo = 0
    while lo < len(ev):
        size = (EVICT_ROWS if rng.random() < 0.75
                else int(rng.integers(*EVICT_LARGE)))
        hi = min(lo + size, len(ev))
        exp.export_evicted(EvictedFlows(
            ev[lo:hi], **{k: v[lo:hi] for k, v in lanes.items()}))
        lo = hi
    return len(ev)


def phase_federation(specs, universe, pool, events, wt_records_per_s
                     ) -> dict:
    """The federation plane at the default geometry (module docstring's
    `federation`): FED_AGENTS lanes-path agents export one delta frame a
    closed window into one aggregator on the card, then FED_IDS sources
    per live agent send a frame each for FED_FANIN_WINDOWS windows; each
    cluster window is held against a host numpy replay and an eager
    replay on the card of the frames it merged."""
    import uuid

    import numpy as np
    import torch
    from netobserv_tpu_torch import config as tconfig
    from netobserv_tpu_torch.alerts import engine as aengine
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    from netobserv_tpu_torch.federation import delta as fdelta
    from netobserv_tpu_torch.federation import pbwire, statemerge
    from netobserv_tpu_torch.federation.aggregator import (
        FederationAggregator,
    )
    from netobserv_tpu_torch.sketch import state as sk
    from netobserv_tpu_torch.utils import retrace, tracing
    try:
        from netobserv_tpu_torch.metrics.registry import Metrics
        metrics = Metrics()
    except ImportError:  # prometheus_client is optional
        metrics = None
    cfg = sk.SketchConfig()
    retraces0 = retrace.total_retraces()
    tracing.configure(sample=1.0, capacity=1 << 14)
    engine = aengine.maybe_engine(tconfig.QuerySettings(
        alert_rules="default", alert_sinks="metrics"), metrics=metrics,
        source="aggregator")
    cluster: list = []
    published: dict = {}
    agents: list = []
    agg = None
    try:
        # the aggregator first: its merge is captured here, before any
        # thread folds (ROADMAP C4)
        t0 = time.perf_counter()
        agg = FederationAggregator(cfg, window_s=3600.0, metrics=metrics,
                                   sink=cluster.append, alerts=engine)
        agg_make_s = time.perf_counter() - t0
        check(agg.device.type == "cuda" and agg._fold.captures == 1,
              f"aggregator on {agg.device}, {agg._fold.captures} captures")
        publish = agg._publish

        def tap(report, tables, agent_ids, wtrace):
            published[int(report.window)] = tables
            return publish(report, tables, agent_ids, wtrace)
        agg._publish = tap
        taps = [FrameTap(agg) for _ in range(FED_AGENTS)]
        sinks = [WindowSink() for _ in range(FED_AGENTS)]
        for a in range(FED_AGENTS):
            exp = TorchSketchExporter(
                cfg, batch_size=BATCH, device="cuda", sink=sinks[a],
                agent_id=f"agent-{a}", delta_sink=taps[a], **LANES_KW)
            with exp._lock:
                exp._ensure_ring()  # every capture before any fold
            agents.append(exp)
        captures0 = [[c.captures for c in e.captures] for e in agents]
        quarters = _agent_quarters(events)
        for s in specs:
            s["kernel"].launches = 0

        # live windows: each agent folds its quarter, then flushes (its
        # frame reaches the aggregator in its publish); the aggregator
        # closes the cluster window by flush()
        fold_s, records, roll_live, flush_ms = 0.0, 0, [], []
        for w in range(WINDOWS):
            rng = np.random.default_rng(100 + w)
            for a, exp in enumerate(agents):
                t0 = time.perf_counter()
                records += _evict(exp, quarters[a], rng)
                with exp._lock:
                    exp._drain_pending()
                torch.cuda.synchronize()
                fold_s += time.perf_counter() - t0
            for exp in agents:
                exp.flush()
                wt = next(t for t in tracing.snapshot()
                          if t["kind"] == "window")
                roll_live.append(_span_ms(wt, "roll_dispatch"))
            t0 = time.perf_counter()
            agg.flush()
            flush_ms.append((time.perf_counter() - t0) * 1e3)
        launches = {s["name"]: s["kernel"].launches for s in specs}
        folds = sum(e.folds for e in agents)
        want = _want_launches(specs, "lanes", folds)
        check(launches == want, f"launches {launches}, want {want}")
        for exp, c0 in zip(agents, captures0):
            check([c.captures for c in exp.captures] == c0,
                  f"an agent captured again: {c0}")
            _watch_stats(exp)
        for a, tp in enumerate(taps):
            check(len(tp.acks) == WINDOWS and all(
                k.accepted == 1 and k.duplicate == 0 for k in tp.acks),
                f"agent-{a} acks {tp.acks}")
        check(len(cluster) == WINDOWS, f"{len(cluster)} cluster reports")
        for w, rep in enumerate(cluster):
            mine = [s.reports[w]["Records"] for s in sinks]
            check(rep["Records"] == sum(mine) and rep["Window"] == w,
                  f"window {w}: cluster records {rep['Records']}, agents "
                  f"{mine}")
            check(rep["Agents"] == [f"agent-{a}" for a in
                                    range(FED_AGENTS)],
                  f"window {w} agents {rep['Agents']}")

        # the decoded tables of each frame the aggregator merged, by
        # window, in its order (the fan-in sends copies of live frames)
        cache = {(a, w): fdelta.upgrade_tables(fdelta.decode_frame(f))
                 for a, tp in enumerate(taps)
                 for w, f in enumerate(tp.frames)}
        merged = {w: [(a, w) for a in range(FED_AGENTS)]
                  for w in range(WINDOWS)}
        raw_bytes = sum(v.nbytes for v in cache[(0, 0)].values())
        raw_frame = len(fdelta.encode_frame(
            sk.state_tables(agg._state), agent_id="agent-0", window=0,
            ts_ms=0, dims=agg._dims, codec=fdelta.CODEC_RAW))

        # the fan-in: FED_IDS sources per live agent, one frame each a
        # window, re-headered from the live frames with fresh uuids
        msgs = {k: pbwire.SketchDelta.FromString(taps[k[0]].frames[k[1]])
                for k in cache}
        ingest_s, spans, fanin_s, checks = [], [], [], {}
        for fw in range(FED_FANIN_WINDOWS):
            w = WINDOWS + fw
            merged[w] = []
            tracing.recorder.clear()
            t_loop = 0.0
            for i in range(FED_IDS):
                for a in range(FED_AGENTS):
                    m = msgs[(a, fw % WINDOWS)]
                    m.agent_id = f"agent-{a}.{i}"
                    m.frame_uuid = uuid.uuid4().hex
                    m.window = m.window_seq = w
                    m.agent_epoch, m.trace_ctx = 1 + a, None
                    data = m.SerializeToString()
                    t0 = time.perf_counter()
                    ack = agg.ingest_frame(data)
                    dt = time.perf_counter() - t0
                    t_loop += dt
                    ingest_s.append(dt)
                    check(ack.accepted == 1 and ack.duplicate == 0,
                          f"fan-in ack {ack}")
                    merged[w].append((a, fw % WINDOWS))
            torch.cuda.synchronize()
            fanin_s.append(t_loop)
            spans += [t for t in tracing.snapshot() if t["kind"] == "delta"]
            if fw == 0:
                checks = _ledger_checks(agg, taps, cache, merged[w], data,
                                        metrics)
            t0 = time.perf_counter()
            agg.flush()
            flush_ms.append((time.perf_counter() - t0) * 1e3)
        check(len(cluster) == WINDOWS + FED_FANIN_WINDOWS,
              f"{len(cluster)} cluster reports")

        # each window against a host numpy replay and an eager replay on
        # the card of the frames it merged
        replay = sk.init_state(cfg, "cuda")
        cmp = []
        for w in sorted(merged):
            got = published[w]
            acc = {}
            for key in merged[w]:
                t = cache[key]
                for k in FED_ADDED:
                    acc[k] = (acc[k] + t[k]) if k in acc else \
                        np.float32(0) + t[k]
                for k in FED_MAXED:
                    acc[k] = np.maximum(acc[k], t[k]) if k in acc else \
                        np.maximum(np.int32(0), t[k])
            for k in (*FED_ADDED, *FED_MAXED):
                check(got[k].dtype == acc[k].dtype
                      and np.array_equal(got[k], acc[k]),
                      f"window {w}: {k} differs from the numpy replay")
            for key in merged[w]:
                host = fdelta.localize_churn(cache[key], w)
                statemerge.merge_tables(replay, {
                    k: torch.from_numpy(np.array(
                        v, dtype=np.int64 if v.dtype == np.uint32
                        else v.dtype)).cuda() for k, v in host.items()})
            eager = sk.state_tables(replay)
            diff = [k for k in eager if not (
                eager[k].dtype == got[k].dtype
                and np.array_equal(eager[k], got[k]))]
            check(not diff, f"window {w}: captured merge differs from the "
                  f"eager replay in {diff}")
            sk.roll_window(replay, cfg)
            cmp.append({"window": w, "frames": len(merged[w]),
                        "records": float(got["scalars"][0]),
                        "heavy_valid": int(got["heavy_valid"].sum())})

        # the roll's cost of the whole state_tables copy: each agent's
        # roll_dispatch on empty windows, with a sink and without
        roll_with, roll_without = [], []
        for exp in agents:
            for _ in range(FED_ROLL_PAIRS):
                for sink, out in ((lambda f: None, roll_with),
                                  (None, roll_without)):
                    exp._delta_sink = sink
                    exp.flush()
                    wt = next(t for t in tracing.snapshot()
                              if t["kind"] == "window")
                    out.append(_span_ms(wt, "roll_dispatch"))
            exp._delta_sink = None

        # the merge's device time and launches (the aggregate is spent
        # after this)
        agg_watch = agg._fold.stats()
        check(agg._fold.captures == 1 and agg_watch["retraces"] == 0
              and agg_watch["calls"] == sum(len(v) for v in merged.values()),
              f"federation_merge {agg_watch}")
        check(retrace.total_retraces() == retraces0,
              f"{retrace.total_retraces() - retraces0} retraces")
        WATCHED.append(agg_watch)
        merge_prof = _profile_merge(agg)
    finally:
        tracing.configure(sample=0.0)
        for exp in agents:
            exp._delta_sink = None
            exp.close()
        if agg is not None:
            agg.close()
    check(retrace.total_retraces() == retraces0, "retraces at close")

    def split(name):
        return [_span_ms(t, name) for t in spans]
    decode, h2d = split("delta_decode"), split("delta_h2d")
    dispatch = [d - h - l for d, h, l in zip(
        split("delta_merge_dispatch"), h2d, split("delta_ledger"))]
    return {"phase": "federation", "agents": FED_AGENTS,
            "fanin_sources": FED_AGENTS * FED_IDS,
            "fanin_windows": FED_FANIN_WINDOWS, "cluster_windows": cmp,
            "frame_raw_bytes": raw_frame, "tables_raw_bytes": raw_bytes,
            "frame_zlib_bytes": [len(f) for tp in taps for f in tp.frames],
            "aggregator_make_s": agg_make_s,
            "ingest_ms_p50": _pct(ingest_s, 50) * 1e3,
            "ingest_ms_p99": _pct(ingest_s, 99) * 1e3,
            "decode_ms_p50": _pct(decode, 50), "decode_ms_p99": _pct(decode, 99),
            "h2d_ms_p50": _pct(h2d, 50), "h2d_ms_p99": _pct(h2d, 99),
            "merge_dispatch_ms_p50": _pct(dispatch, 50),
            "merge_dispatch_ms_p99": _pct(dispatch, 99),
            "live_ingest_ms": [s * 1e3 for tp in taps for s in tp.seconds],
            **merge_prof,
            "fanin_frames_per_s": [FED_AGENTS * FED_IDS / s
                                   for s in fanin_s],
            "fanin_tables_gb_per_window": FED_AGENTS * FED_IDS * raw_bytes
            / 1e9,
            "cluster_flush_ms": flush_ms,
            "agent_roll_dispatch_live_ms": roll_live,
            "agent_roll_dispatch_with_sink_ms_median":
                float(np.median(roll_with)),
            "agent_roll_dispatch_without_sink_ms_median":
                float(np.median(roll_without)),
            "agent_roll_dispatch_with_sink_ms": roll_with,
            "agent_roll_dispatch_without_sink_ms": roll_without,
            "agents_records": records, "agents_fold_s": fold_s,
            "agents_records_per_s": records / fold_s,
            "window_thread_records_per_s": wt_records_per_s,
            "alert_transitions": (engine.view()["transition_seq"]
                                  if engine is not None else None),
            "ledger": checks, "launches": launches,
            "federation_merge": agg_watch}


def _profile_merge(agg, n: int = 10) -> dict:
    """The captured merge's replays (the aggregate is spent after them):
    CUDA-event ms a replay over REPS replays, and device ms and kernels a
    replay from a torch.profiler trace of n replays, which must be whole
    (every kernel a multiple of n times) within PROFILE_TRIES traces, or
    the phase fails. A trace that starts with a replay came back five
    records short, the graph's first five kernels (`profile()` alone,
    after a full run's earlier phases), so one replay runs as the
    profiler's warm-up step, whose events it drops, before the n that it
    keeps."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    def replay():
        agg._fold(agg._state, agg._dev)
    for _ in range(5):
        replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        replay()
    end.record()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        rows: list = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: rows.extend(
                         _device_rows(p))) as prof:
            replay()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(n):
                replay()
            torch.cuda.synchronize()
            prof.step()
        short = [[name[:90], count] for _, name, count in rows
                 if count % n]
        if rows and not short:
            break
        PROFILE_RETRIED.append(1)
    else:
        raise PhaseError(f"no whole trace of the merge in {PROFILE_TRIES} "
                         f"traces; the last one's rows short: {short}")
    return {"merge_event_ms": start.elapsed_time(end) / REPS,
            "merge_device_ms": sum(r[0] for r in rows) / 1e3 / n,
            "merge_kernels_per_replay": sum(r[2] for r in rows) / n,
            "merge_top_kernels": [[r[1][:60], r[0] / n, r[2] / n]
                                  for r in rows[:8]]}


def _ledger_checks(agg, taps, cache, merged: list, last: bytes,
                   metrics) -> dict:
    """The verdicts on the card, inside the first fan-in window: a
    redelivered frame, a stale one, a v2 and a v1 frame (each merged, so
    added to `merged`), then a truncated frame and one of another
    geometry, rejected with every table unchanged."""
    import numpy as np
    from netobserv_tpu_torch.federation import delta as fdelta
    from netobserv_tpu_torch.federation import pbwire
    from netobserv_tpu_torch.sketch import state as sk
    out = {}
    ack = agg.ingest_frame(last)
    check(ack.accepted == 1 and ack.duplicate == 1
          and ack.reason == fdelta.ACK_REASON_DUPLICATE,
          f"redelivery ack {ack}")
    out["duplicate"] = ack.reason
    m = pbwire.SketchDelta.FromString(last)
    m.window_seq -= 1
    m.frame_uuid = "stale-" + m.frame_uuid
    ack = agg.ingest_frame(m.SerializeToString())
    check(ack.accepted == 1 and ack.duplicate == 1
          and ack.reason == fdelta.ACK_REASON_STALE, f"stale ack {ack}")
    out["stale"] = ack.reason
    live = fdelta.decode_frame(taps[0].frames[0]).tables
    for version in (2, 1):
        data = fdelta.encode_frame(
            live, agent_id=f"legacy-v{version}", window=agg._window_host,
            ts_ms=0, dims=agg._dims, agent_epoch=7, version=version)
        frame = fdelta.decode_frame(data)
        up = fdelta.upgrade_tables(frame)
        check(all(not up[k].any() for k in ("heavy_prev_counts",
                                            "heavy_first_seen",
                                            "heavy_epoch")),
              f"v{version}: churn tensors not zero")
        ack = agg.ingest_frame(data)
        check(ack.accepted == 1 and ack.duplicate == 0 and not ack.reason,
              f"v{version} ack {ack}")
        cache[(f"v{version}",)] = up
        merged.append((f"v{version}",))
    check("legacy-v2" in agg._ledger and "legacy-v1" not in agg._ledger
          and "legacy-v1" in agg._agents, "v1 did not merge as legacy")
    if metrics is not None:
        get = metrics.registry.get_sample_value
        out["legacy"] = get("ebpf_agent_federation_deltas_total",
                            {"result": "legacy"})
        check(out["legacy"] == 1.0, f"legacy count {out['legacy']}")
    with agg._lock, agg._on_device():
        before = sk.state_tables(agg._state)
    other = sk.SketchConfig(cm_width=1 << 15)
    wrong = fdelta.encode_frame(
        sk.state_tables(sk.init_state(other, "cuda")), agent_id="skewed",
        window=0, ts_ms=0, dims={**agg._dims, "cm_width": 1 << 15})
    for name, data in (("truncated", last[:len(last) // 2]),
                       ("wrong_geometry", wrong)):
        ack = agg.ingest_frame(data)
        check(ack.accepted == 0, f"{name} frame accepted")
        out[name] = ack.reason[:80]
    with agg._lock, agg._on_device():
        after = sk.state_tables(agg._state)
    check(all(np.array_equal(before[k], after[k]) for k in before),
          "a rejected frame changed a table")
    return out


#: the archive phase: windows closed by `flush()`, records a window (two
#: batches), and the archive's retention and ladder (module docstring)
ARC_WINDOWS = 48
ARC_ROWS = 2 * BATCH
ARC_RAW, ARC_GROUP, ARC_LEVELS, ARC_LADDER = 6, 2, 2, 16
#: empty-window roll pairs timed with the archive and checkpoint on and off
ARC_ROLL_PAIRS = 3
#: the range thread's pause between requests
ARC_POLL_PAUSE_S = 0.1
#: windows archived straight through the archive while a thread folds
#: (the longest `export_evicted` while a compaction runs)
ARC_CONTEND = 8


def _timed(fn, out: list, when=None):
    """`fn`, appending each call's (start, end) perf_counter span to `out`
    (only calls whose result passes `when`, if given)."""
    def wrapped(*args, **kw):
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        if when is None or when(res):
            out.append((t0, time.perf_counter()))
        return res
    return wrapped


def _ms(spans) -> list:
    return [(b - a) * 1e3 for a, b in spans]


def _replay_ladder(engine, table_dicts, cfg) -> dict:
    """The engine's merge, eagerly on the card: `merge_tables_host`'s
    chunks of ladder_max (the merged tables re-entering first), each into
    a zero state with its zero pads, through `statemerge.merge_tables` op
    by op; returns the last chunk's pre-roll tables."""
    import numpy as np
    import torch
    from netobserv_tpu_torch.federation import statemerge
    from netobserv_tpu_torch.sketch import state as sk
    cap = engine.ladder[-1]
    pending = list(table_dicts)
    while True:
        chunk, pending = pending[:cap], pending[cap:]
        k = engine._ladder_fit(len(chunk))
        state = sk.init_state(cfg, "cuda")
        for t in chunk + [engine._zero_template()] * (k - len(chunk)):
            statemerge.merge_tables(state, {
                name: torch.from_numpy(np.array(
                    v, dtype=np.int64 if v.dtype == np.uint32
                    else v.dtype)).cuda() for name, v in t.items()})
        tables = sk.state_tables(state)
        if not pending:
            return tables
        pending = [tables] + pending


def _numpy_replay(table_dicts) -> dict:
    """The added tables summed in order in f32 and the HLL banks' maxima,
    on the host."""
    import numpy as np
    acc: dict = {}
    for t in table_dicts:
        for k in FED_ADDED:
            acc[k] = (acc[k] + t[k]) if k in acc else np.float32(0) + t[k]
        for k in FED_MAXED:
            acc[k] = np.maximum(acc[k], t[k]) if k in acc else \
                np.maximum(np.int32(0), t[k])
    return acc


def _chain_replay(engine, table_dicts) -> dict:
    """`_numpy_replay` chunked as the engine chains: chunks of ladder_max,
    each chunk's result re-entering the next first."""
    cap = engine.ladder[-1]
    pending = list(table_dicts)
    while True:
        chunk, pending = pending[:cap], pending[cap:]
        acc = _numpy_replay(chunk)
        if not pending:
            return acc
        pending = [acc] + pending


#: the exporters phase: the records through the record exporters, the
#: gRPC leg's small batch (at 2 flows a message), the share of UDP and of
#: the TLS leg, and the pushes timed over the wire and in process after
#: the two live windows
EXP_RECORDS = 20_000
EXP_SMALL = 2_000
EXP_UDP = 5_000
EXP_PUSH_ROUNDS = 32
#: the IANA information elements of the IPFIX templates (RFC 7011/7012):
#: the shared head, then the v4 and v6 address and ICMP elements
EXP_IPFIX_HEAD = [(152, 8), (153, 8), (1, 8), (2, 8), (10, 4), (61, 1),
                  (56, 6), (80, 6), (256, 2), (4, 1), (6, 2), (7, 2),
                  (11, 2)]
EXP_IPFIX_TEMPLATES = {
    256: EXP_IPFIX_HEAD + [(8, 4), (12, 4), (176, 1), (177, 1)],
    257: EXP_IPFIX_HEAD + [(27, 16), (28, 16), (178, 1), (179, 1)]}


def _exp_records(events) -> list:
    """EXP_RECORDS records of the lanes stream (`records_from_events`),
    seeded into v4 and v6 keys, ICMP and ICMPv6, DNS, drops, RTT, xlat,
    TLS, QUIC, IPsec and network events."""
    import numpy as np
    from netobserv_tpu_torch.model.flow import (
        IP4_IN_6_PREFIX, FlowFeatures, FlowKey,
    )
    from netobserv_tpu_torch.model.record import records_from_events
    ev = LaneFeeder(events).stream[0][:EXP_RECORDS]
    recs = records_from_events(ev, agent_ip="127.0.0.1")
    rng = np.random.default_rng(24)
    for i, r in enumerate(recs):
        k = r.key
        v4 = i % 2 == 0
        if v4:
            k = FlowKey(IP4_IN_6_PREFIX + k.src_ip[12:],
                        IP4_IN_6_PREFIX + k.dst_ip[12:], k.src_port,
                        k.dst_port, k.proto)
        r.eth_protocol = 0x0800 if v4 else 0x86DD
        if i % 10 in (3, 4):
            k = FlowKey(k.src_ip, k.dst_ip, 0, 0, 1 if v4 else 58,
                        int(rng.integers(0, 256)), int(rng.integers(0, 16)))
        f = FlowFeatures()
        if i % 5 == 1:
            f.dns_id = int(rng.integers(1, 1 << 16))
            f.dns_flags = 0x8180
            f.dns_latency_ns = int(rng.integers(1, 10**8))
            f.dns_name = f"host{i % 97}.example.com"
        if i % 7 == 2:
            f.drop_bytes = int(rng.integers(1, 1 << 20))
            f.drop_packets = int(rng.integers(1, 100))
            f.drop_latest_flags = int(rng.integers(0, 1 << 9))
            f.drop_latest_state = int(rng.integers(0, 12))
            f.drop_latest_cause = int(rng.integers(0, 1 << 9))
        if i % 3 == 0:
            f.rtt_ns = int(rng.integers(1, 10**9))
        if i % 11 == 5:
            f.xlat_src_ip = IP4_IN_6_PREFIX + rng.bytes(4)
            f.xlat_dst_ip = k.dst_ip
            f.xlat_src_port = int(rng.integers(1, 1 << 16))
            f.xlat_dst_port = k.dst_port
            f.xlat_zone_id = int(rng.integers(0, 1 << 16))
        if i % 13 == 6:
            f.quic_version = 1
            f.quic_seen_long_hdr = True
            f.quic_seen_short_hdr = bool(i % 2)
        if i % 17 == 8:
            f.network_events = [bytes([1, 1, 2, 0]) + rng.bytes(4)]
        if i % 19 == 9:
            f.ipsec_encrypted = True
            f.ipsec_encrypted_ret = -int(rng.integers(0, 100))
        if i % 9 == 4:
            r.ssl_version = 0x0304
            r.tls_cipher_suite = 0x1301
            r.tls_key_share = 0x001D
            r.tls_types = 0x0B
            r.ssl_mismatch = bool(i % 2)
        r.key, r.features = k, f
    return recs


def _pbflow_view(r) -> tuple:
    """Every field of a record that pbflow carries, as `pb_convert`
    carries it (the DNS and drop blocks only when set)."""
    f = r.features
    dns = bool(f.dns_id or f.dns_latency_ns or f.dns_errno)
    drop = bool(f.drop_bytes or f.drop_packets)
    xlat = (f.xlat_src_ip, f.xlat_dst_ip, f.xlat_src_port, f.xlat_dst_port,
            f.xlat_zone_id) if f.xlat_src_ip else None
    return (r.key, r.bytes_, r.packets, r.eth_protocol, r.tcp_flags,
            int(r.direction == 1), r.src_mac, r.dst_mac, r.interface,
            r.dscp, r.sampling, r.time_flow_start_ns, r.time_flow_end_ns,
            r.agent_ip, [(n, int(d == 1), u) for n, d, u in r.dup_list],
            (f.dns_id, f.dns_flags, f.dns_errno, f.dns_latency_ns,
             f.dns_name) if dns else None,
            (f.drop_bytes, f.drop_packets, f.drop_latest_flags,
             f.drop_latest_state, f.drop_latest_cause) if drop else None,
            f.rtt_ns, xlat, bool(f.ipsec_encrypted), f.ipsec_encrypted_ret,
            (f.quic_version, bool(f.quic_seen_long_hdr),
             bool(f.quic_seen_short_hdr)), r.ssl_version,
            bool(r.ssl_mismatch), r.tls_types, r.tls_cipher_suite,
            r.tls_key_share)


class _WireCount:
    """Bytes the port's gRPC transport writes, over every connection."""

    def __init__(self):
        from netobserv_tpu_torch.grpc import h2
        self.h2, self.n = h2, 0
        self.saved = (h2._Plain.send, h2._Tls.send)

    def __enter__(self):
        plain, tls = self.saved

        def count(fn):
            def send(t, data):
                self.n += len(data)
                return fn(t, data)
            return send
        self.h2._Plain.send, self.h2._Tls.send = count(plain), count(tls)
        return self

    def __exit__(self, *exc):
        self.h2._Plain.send, self.h2._Tls.send = self.saved


def _exp_grpc_leg(recs, per_message: int, tls: dict | None) -> dict:
    """The records through `GRPCFlowExporter` into the port's
    `start_flow_collector`; each received record equal to its original
    in every field pbflow carries."""
    from netobserv_tpu_torch.exporter.grpc_flow import GRPCFlowExporter
    from netobserv_tpu_torch.exporter.pb_convert import pb_to_record
    from netobserv_tpu_torch.grpc.flow import start_flow_collector
    tls = tls or {}
    srv, port, out = start_flow_collector(
        0, tls_cert=tls.get("cert", ""), tls_key=tls.get("key", ""))
    try:
        exp = GRPCFlowExporter("127.0.0.1", port,
                               max_flows_per_message=per_message,
                               tls_ca=tls.get("cert", ""))
        try:
            with _WireCount() as wire:
                t0 = time.perf_counter()
                exp.export_batch(recs)
                dt = time.perf_counter() - t0
        finally:
            exp.close()
        msgs = [out.get(timeout=10) for _ in range(-(-len(recs)
                                                       // per_message))]
        check(out.empty(), "the collector got more messages than sent")
    finally:
        srv.stop(None)
    got = [pb_to_record(e) for m in msgs for e in m.entries]
    check(len(got) == len(recs), f"{len(got)} of {len(recs)} records")
    bad = [i for i, (g, r) in enumerate(zip(got, recs))
           if _pbflow_view(g) != _pbflow_view(r)]
    check(not bad, f"gRPC at {per_message} a message: records {bad[:5]} "
          "differ")
    return {"flows_per_s": len(recs) / dt, "messages": len(msgs),
            "wire_bytes_per_flow": wire.n / len(recs)}


def _ipfix_expect(r, v6: bool) -> dict:
    ip = (lambda b: b) if v6 else (lambda b: b[12:16])
    return {152: r.time_flow_start_ns // 1_000_000,
            153: r.time_flow_end_ns // 1_000_000, 1: r.bytes_,
            2: r.packets, 10: r.if_index, 61: r.direction & 0xFF,
            56: r.src_mac, 80: r.dst_mac, 256: r.eth_protocol,
            4: r.key.proto, 6: r.tcp_flags & 0xFFFF, 7: r.key.src_port,
            11: r.key.dst_port, (27 if v6 else 8): ip(r.key.src_ip),
            (28 if v6 else 12): ip(r.key.dst_ip),
            (178 if v6 else 176): r.key.icmp_type,
            (179 if v6 else 177): r.key.icmp_code}


def _ipfix_check(msgs: list, recs: list) -> int:
    """Decode IPFIX messages: the templates must be EXP_IPFIX_TEMPLATES,
    each header's sequence number the data records before it, and the
    data records, in order, the v4 records then the v6 ones with every
    field equal. Returns the data records decoded."""
    import struct
    from netobserv_tpu_torch.model.flow import IP4_IN_6_PREFIX
    templates, seq, got = {}, 0, []
    for m in msgs:
        version, length, _, mseq, domain = struct.unpack(">HHIII", m[:16])
        check(version == 10 and length == len(m) and domain == 1,
              f"IPFIX header {version} {length}/{len(m)} {domain}")
        check(mseq == seq, f"IPFIX sequence {mseq}, want {seq}")
        off = 16
        while off < len(m):
            sid, slen = struct.unpack(">HH", m[off:off + 4])
            body = m[off + 4:off + slen]
            if sid == 2:
                p = 0
                while p < len(body):
                    tid, n = struct.unpack(">HH", body[p:p + 4])
                    templates[tid] = [struct.unpack(">HH", body[q:q + 4])
                                      for q in range(p + 4, p + 4 + 4 * n,
                                                     4)]
                    p += 4 + 4 * n
            else:
                fields = templates[sid]
                size = sum(n for _, n in fields)
                for q in range(0, len(body), size):
                    rec, o = {}, q
                    for ie, n in fields:
                        v = body[o:o + n]
                        rec[ie] = (v if ie in (56, 80, 8, 12, 27, 28)
                                   else int.from_bytes(v, "big"))
                        o += n
                    got.append((sid, rec))
                seq += len(body) // size
            off += slen
    check(templates == EXP_IPFIX_TEMPLATES, f"IPFIX templates {templates}")

    def v6(r):
        return (r.eth_protocol == 0x86DD
                or r.key.src_ip[:12] != IP4_IN_6_PREFIX
                or r.key.dst_ip[:12] != IP4_IN_6_PREFIX)
    want = ([(256, _ipfix_expect(r, False)) for r in recs if not v6(r)]
            + [(257, _ipfix_expect(r, True)) for r in recs if v6(r)])
    check(len(got) == len(want), f"IPFIX: {len(got)} of {len(want)} "
          "records")
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    check(not bad, f"IPFIX records {bad[:5]} differ")
    return len(got)


def _exp_ipfix(recs: list, transport: str) -> dict:
    """The records through `IPFIXExporter` to a local socket read on a
    thread of its own, then decoded and checked (`_ipfix_check`)."""
    import socket
    import struct
    import threading
    from netobserv_tpu_torch.exporter.ipfix import IPFIXExporter
    chunks, stop = [], threading.Event()
    if transport == "udp":
        rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 16 << 20)
        rx.bind(("127.0.0.1", 0))
    else:
        rx = socket.create_server(("127.0.0.1", 0))
    rx.settimeout(0.2)

    def read():
        conn = rx
        if transport == "tcp":
            conn = None
            while conn is None and not stop.is_set():
                try:
                    conn, _ = rx.accept()
                except socket.timeout:
                    pass
            if conn is None:
                return
            conn.settimeout(0.2)
        while True:
            try:
                data = conn.recv(65535)
            except socket.timeout:
                if stop.is_set():
                    break
                continue
            if not data:
                break
            chunks.append(data)
        if conn is not rx:
            conn.close()
    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        exp = IPFIXExporter("127.0.0.1", rx.getsockname()[1],
                            transport=transport)
        t0 = time.perf_counter()
        exp.export_batch(recs)
        dt = time.perf_counter() - t0
        exp.close()
        time.sleep(0.3)
    finally:
        stop.set()
        reader.join(timeout=10)
        rx.close()
    if transport == "udp":
        msgs = chunks
    else:
        stream, msgs, off = b"".join(chunks), [], 0
        while off < len(stream):
            n = struct.unpack(">H", stream[off + 2:off + 4])[0]
            msgs.append(stream[off:off + n])
            off += n
    n = _ipfix_check(msgs, recs)
    return {"flows_per_s": n / dt, "messages": len(msgs),
            "wire_bytes_per_flow": sum(map(len, msgs)) / n}


def _exp_tls_files(tmp: str) -> dict | None:
    """A self-signed certificate for 127.0.0.1 made by `openssl`, or None
    where there is no `openssl`."""
    import os
    import shutil
    if shutil.which("openssl") is None:
        return None
    cert, key = os.path.join(tmp, "cert.pem"), os.path.join(tmp, "key.pem")
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048",
                    "-nodes", "-keyout", key, "-out", cert, "-days", "1",
                    "-subj", "/CN=localhost", "-addext",
                    "subjectAltName=IP:127.0.0.1,DNS:localhost"],
                   check=True, capture_output=True, timeout=60)
    return {"cert": cert, "key": key}


def _exp_records_part(events, tmp: str) -> dict:
    """`exporters` (a): the record exporters on this machine."""
    import io
    import json
    from netobserv_tpu_torch.exporter.stdout_json import StdoutJSONExporter
    recs = _exp_records(events)
    out = {"records": len(recs)}
    out["grpc_2"] = _exp_grpc_leg(recs[:EXP_SMALL], 2, None)
    out["grpc_10000"] = _exp_grpc_leg(recs, 10_000, None)
    tls = _exp_tls_files(tmp)
    if tls is None:
        print("exporters: skip the gRPC leg over TLS: no openssl on PATH "
              "to make a certificate", flush=True)
        out["grpc_tls"] = "skipped: no openssl on PATH"
    else:
        out["grpc_tls"] = _exp_grpc_leg(recs[:EXP_UDP], 10_000, tls)
    out["ipfix_udp"] = _exp_ipfix(recs[:EXP_UDP], "udp")
    out["ipfix_tcp"] = _exp_ipfix(recs, "tcp")
    buf = io.StringIO()
    t0 = time.perf_counter()
    StdoutJSONExporter(stream=buf).export_batch(recs)
    dt = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    check(len(lines) == len(recs), f"{len(lines)} stdout lines")
    bad = [i for i, (line, r) in enumerate(zip(lines, recs))
           if json.loads(line) != r.to_json_obj()]
    check(not bad, f"stdout lines {bad[:5]} differ from to_json_obj")
    out["stdout"] = {"flows_per_s": len(recs) / dt,
                     "wire_bytes_per_flow": len(buf.getvalue()) / len(recs)}
    legs = [k for k in ("grpc_2", "grpc_10000", "grpc_tls", "ipfix_udp",
                        "ipfix_tcp", "stdout") if isinstance(out[k], dict)]
    print("exporters: flows/s " + ", ".join(
        f"{k} {out[k]['flows_per_s']:.0f}" for k in legs)
        + "; wire bytes a flow " + ", ".join(
        f"{k} {out[k]['wire_bytes_per_flow']:.1f}" for k in legs),
        flush=True)
    return out


def _exp_child(tmp: str) -> dict:
    """`exporters` (b): the DaemonSet's configuration as a process."""
    import os
    import queue
    from netobserv_tpu_torch.grpc.flow import start_flow_collector
    srv, port, out = start_flow_collector(0)
    mport = _free_port()
    base = f"http://127.0.0.1:{mport}"
    res = {"ladder_rung_expected": _expected_rung()[0]}
    proc, fo, fe = _agent_child(
        os.path.dirname(os.path.abspath(__file__)), {
            "EXPORT": "grpc", "TARGET_HOST": "127.0.0.1",
            "TARGET_PORT": str(port), "INTERFACES": "lo",
            "EXCLUDE_INTERFACES": "", "LISTEN_INTERFACES": "poll",
            "CACHE_ACTIVE_TIMEOUT": AE_CHILD_TICK,
            "METRICS_ENABLE": "true", "METRICS_SERVER_ADDRESS": "127.0.0.1",
            "METRICS_SERVER_PORT": str(mport)}, tmp, "grpc_child")
    try:
        res["start_to_started_s"] = _wait_started(proc, base)
        flows, msgs, deadline = 0, 0, time.monotonic() + 60
        while flows == 0 and time.monotonic() < deadline:
            try:
                flows += len(out.get(timeout=1).entries)
                msgs += 1
            except queue.Empty:
                check(proc.poll() is None,
                      f"the child exited {proc.returncode}")
        res["flows_before_sigterm"] = flows
        res["sigterm_to_exit_s"] = _sigterm(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        fo.close()
        fe.close()
        srv.stop(None)
    with open(fe.name, "rb") as fh:
        err = fh.read().decode(errors="replace")
    check(proc.returncode == 0, f"EXPORT=grpc child: exit "
          f"{proc.returncode}, {err[-1500:]!r}")
    check(res["flows_before_sigterm"] > 0,
          f"the collector got no flows from the child: {err[-1500:]!r}")
    print(f"exporters: EXPORT=grpc child Started in "
          f"{res['start_to_started_s']:.2f} s, {flows} flows reached the "
          "collector before SIGTERM", flush=True)
    return res


def _exp_agents(target: str, device: str, sinks: list) -> list:
    """FED_AGENTS lanes-path agents from `TorchSketchExporter.from_config`
    with FEDERATION_TARGET `target`, each ring captured."""
    from netobserv_tpu_torch import config as tconfig
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    agents = []
    try:
        for a in range(FED_AGENTS):
            env = {"EXPORT": "tpu-sketch", "SKETCH_BATCH_SIZE": str(BATCH),
                   "SKETCH_WINDOW": "1h", "SKETCH_PACK_THREADS": "8",
                   "SKETCH_SUPERBATCH": "1,2,4",
                   "FEDERATION_TARGET": target,
                   "FEDERATION_AGENT_ID": f"agent-{a}",
                   **({"SKETCH_DEVICES": "cpu"} if device == "cpu" else {})}
            exp = TorchSketchExporter.from_config(tconfig.load_config(env),
                                                  sink=sinks[a])
            agents.append(exp)
            with exp._lock:
                exp._ensure_ring()  # every capture before the server
    except BaseException:
        for exp in agents:
            exp.close()
        raise
    return agents


def _exp_windows(agents, agg, quarters) -> int:
    """The federation phase's schedule: each agent folds its quarter of a
    window, then each closes it by `flush()` from this thread (its frame
    pushed in agent order), then the aggregator closes the cluster
    window."""
    import numpy as np
    records = 0
    for w in range(WINDOWS):
        rng = np.random.default_rng(100 + w)
        for a, exp in enumerate(agents):
            records += _evict(exp, quarters[a], rng)
            with exp._lock:
                exp._drain_pending()
        for exp in agents:
            exp.flush()
        agg.flush()
    return records


def _published(agg) -> dict:
    """The tables each cluster window publishes, by window."""
    out = {}
    publish = agg._publish

    def tap(report, tables, agent_ids, wtrace):
        out[int(report.window)] = tables
        return publish(report, tables, agent_ids, wtrace)
    agg._publish = tap
    return out


class _TimedSink:
    """An agent's `FederationDeltaSink`, each call's frame, verdict and
    wall seconds kept."""

    def __init__(self, sink):
        self.sink = sink
        self.frames, self.results, self.seconds = [], [], []

    def __call__(self, frame: bytes):
        t0 = time.perf_counter()
        ok = self.sink(frame)
        self.seconds.append(time.perf_counter() - t0)
        self.frames.append(frame)
        self.results.append(ok)
        return ok

    def close(self):
        self.sink.close()


def _exp_failures(frame: bytes, agg, port: int) -> dict:
    """`exporters` (c)'s three failure cases over the port's transport."""
    import uuid
    from netobserv_tpu_torch.exporter.federation import FederationDeltaSink
    from netobserv_tpu_torch.federation import pbwire
    from netobserv_tpu_torch.grpc import h2
    from netobserv_tpu_torch.grpc.federation import (
        classify_rpc_error, start_federation_collector,
    )

    def fresh(agent: str) -> bytes:
        m = pbwire.SketchDelta.FromString(frame)
        m.agent_id, m.frame_uuid = agent, uuid.uuid4().hex
        m.trace_ctx = None
        return m.SerializeToString()

    def counted(sink) -> list:
        results, count = [], sink._count
        sink._count = lambda r, n: (results.append(r), count(r, n))[1]
        return results
    out = {}
    # a cold start: the sink is made before its server exists
    cold_port = _free_port()
    sink = FederationDeltaSink("127.0.0.1", cold_port, retries=2,
                               backoff_initial_s=0.01, timeout_s=2.0)
    srv = None
    try:
        check(sink(fresh("cold-0")) is False, "a push with no server "
              "succeeded")
        srv, bound, _ = start_federation_collector(
            cold_port, handler=agg.ingest_frame)
        check(bound == cold_port, f"bound {bound}, want {cold_port}")
        check(sink(fresh("cold-1")) is True, "the sink never recovered "
              "from its cold start")
        out["cold_start"] = "delivered after the server appeared"
    finally:
        sink.close()
        if srv is not None:
            srv.stop(None)
    # a server without Push: UNIMPLEMENTED, one attempt, terminal
    bare = h2.Server(max_workers=1)
    bare_port = bare.add_port("127.0.0.1:0")
    bare.start()
    sink = FederationDeltaSink("127.0.0.1", bare_port, retries=3,
                               backoff_initial_s=0.01)
    try:
        results, sends, send = counted(sink), [], sink._client.send
        sink._client.send = lambda f, timeout_s=10.0: (
            sends.append(1), send(f, timeout_s))[1]
        check(sink(fresh("bare-0")) is False, "a push to a server without "
              "Push succeeded")
        check(len(sends) == 1 and results == ["terminal"]
              and sink.last_ladder == [],
              f"no Push: {len(sends)} attempts, {results}, ladder "
              f"{sink.last_ladder}")
        out["unimplemented"] = {"attempts": len(sends), "counted": results}
    finally:
        sink.close()
        bare.stop(None)
    # a raw frame over grpc's 4 MiB receive limit
    sink = FederationDeltaSink("127.0.0.1", port, retries=2,
                               backoff_initial_s=0.01)
    try:
        big = bytes(h2.MAX_MESSAGE + 1)
        try:
            sink._client.send(big, timeout_s=30.0)
            raise PhaseError("a frame over 4 MiB was accepted")
        except h2.RpcError as exc:
            check(exc.code() == h2.StatusCode.RESOURCE_EXHAUSTED,
                  f"over 4 MiB: {exc.code().name} {exc.details()}")
            verdict = classify_rpc_error(exc)
        check(verdict == "retry", f"RESOURCE_EXHAUSTED is {verdict}")
        results = counted(sink)
        check(sink(big) is False and results == ["error"]
              and sink.last_ladder == [0.01],
              f"over 4 MiB: {results}, ladder {sink.last_ladder}")
        out["oversize"] = {"code": "RESOURCE_EXHAUSTED", "class": verdict}
    finally:
        sink.close()
    return out


def _exp_federation(specs, events, device: str) -> dict:
    """`exporters` (c): FEDERATION_TARGET on the card."""
    import uuid

    import numpy as np
    import torch
    from netobserv_tpu_torch.federation import pbwire
    from netobserv_tpu_torch.federation.aggregator import (
        FederationAggregator,
    )
    from netobserv_tpu_torch.grpc.federation import (
        FederationClient, start_federation_collector,
    )
    from netobserv_tpu_torch.sketch import state as sk
    cfg = sk.SketchConfig()
    quarters = _agent_quarters_of(_integer_stream(events))
    agg_device = "cpu" if device == "cpu" else None
    res = {}
    # the in-process run: the same schedule, each frame handed to the
    # aggregator's ingest_frame (the aggregator first, then the rings)
    agg = FederationAggregator(cfg, window_s=3600.0, sink=lambda o: None,
                               device=agg_device)
    agents = []
    try:
        want = _published(agg)
        sinks = [WindowSink() for _ in range(FED_AGENTS)]
        agents = _exp_agents(f"127.0.0.1:{_free_port()}", device, sinks)
        taps = []
        for exp in agents:
            exp._delta_sink.close()  # never dialled: it connects lazily
            exp._delta_sink = FrameTap(agg)
            taps.append(exp._delta_sink)
        _exp_windows(agents, agg, quarters)
        check(all(len(t.acks) == WINDOWS and all(k.accepted == 1 for k in
                                                 t.acks) for t in taps),
              "in-process acks")
    finally:
        for exp in agents:
            exp.close()
        agg.close()
    local_ms = [s * 1e3 for t in taps for s in t.seconds]
    # over the wire: the aggregator, every ring captured, then the server
    port = _free_port()
    agg = FederationAggregator(cfg, window_s=3600.0, sink=lambda o: None,
                               device=agg_device)
    agents, srv, client = [], None, None
    try:
        got = _published(agg)
        sinks = [WindowSink() for _ in range(FED_AGENTS)]
        agents = _exp_agents(f"127.0.0.1:{port}", device, sinks)
        wired = []
        for exp in agents:
            check(type(exp._delta_sink).__name__ == "FederationDeltaSink",
                  f"FEDERATION_TARGET built {type(exp._delta_sink)}")
            exp._delta_sink = _TimedSink(exp._delta_sink)
            wired.append(exp._delta_sink)
        captures0 = [[c.captures for c in e.captures] for e in agents]
        srv, bound, _ = start_federation_collector(port,
                                                   handler=agg.ingest_frame)
        check(bound == port, f"bound {bound}, want {port}")
        for s in specs:
            s["kernel"].launches = 0
        plain_calls: dict = {}
        with counting_plains(specs, plain_calls):
            records = _exp_windows(agents, agg, quarters)
            if device != "cpu":
                torch.cuda.synchronize()
        launches = {s["name"]: s["kernel"].launches for s in specs}
        folds = sum(e.folds for e in agents)
        check(launches == _want_launches(specs, "lanes", folds),
              f"launches {launches}, want "
              f"{_want_launches(specs, 'lanes', folds)}")
        check(not plain_calls, f"plain versions ran: {plain_calls}")
        for exp, c0 in zip(agents, captures0):
            check([c.captures for c in exp.captures] == c0,
                  f"an agent captured again: {c0}")
        check(all(w.results == [True] * WINDOWS for w in wired),
              f"pushes {[w.results for w in wired]}")
        # (the in-process aggregator published an empty third window at
        # its close)
        check(sorted(got) == list(range(WINDOWS))
              and set(got) <= set(want),
              f"cluster windows {sorted(got)} and {sorted(want)}")
        for w in range(WINDOWS):
            diff = [k for k in want[w] if not (
                got[w][k].dtype == want[w][k].dtype
                and np.array_equal(got[w][k], want[w][k]))]
            check(not diff, f"cluster window {w}: {diff} differ from the "
                  "in-process run")
        for w in range(WINDOWS):
            mine = sum(s.reports[w]["Records"] for s in sinks)
            check(float(got[w]["scalars"][0]) == mine,
                  f"cluster window {w} records {got[w]['scalars'][0]}, "
                  f"agents {mine}")
        res.update(records=records, folds=folds, launches=launches)
        # the pushes timed: each live frame re-headered under fresh ids,
        # over the wire and into ingest_frame in process
        client = FederationClient("127.0.0.1", port)
        wire_s, local_s = [], []
        with _WireCount() as wire:
            for i in range(EXP_PUSH_ROUNDS):
                for a, tap in enumerate(wired):
                    m = pbwire.SketchDelta.FromString(tap.frames[0])
                    m.window = m.window_seq = WINDOWS
                    m.agent_epoch, m.trace_ctx = 1 + a, None
                    for side in ("wire", "local"):
                        m.agent_id = f"agent-{a}.{i}.{side}"
                        m.frame_uuid = uuid.uuid4().hex
                        data = m.SerializeToString()
                        t0 = time.perf_counter()
                        ack = (client.send(data) if side == "wire"
                               else agg.ingest_frame(data))
                        (wire_s if side == "wire" else local_s).append(
                            time.perf_counter() - t0)
                        check(ack.accepted == 1 and ack.duplicate == 0,
                              f"{side} push ack {ack}")
        client.close()
        client = None
        res["failures"] = _exp_failures(wired[0].frames[0], agg, port)
    finally:
        if client is not None:
            client.close()
        for exp in agents:
            exp.close()
        if srv is not None:
            srv.stop(None)
        agg.close()
    live = [s * 1e3 for w in wired for s in w.seconds]
    frame_bytes = [len(f) for w in wired for f in w.frames]
    res.update(
        push_wire_ms_p50=_pct(wire_s, 50) * 1e3,
        push_wire_ms_p99=_pct(wire_s, 99) * 1e3,
        ingest_frame_ms_p50=_pct(local_s, 50) * 1e3,
        ingest_frame_ms_p99=_pct(local_s, 99) * 1e3,
        live_push_wire_ms=live, live_ingest_frame_ms=local_ms,
        frame_bytes=frame_bytes,
        wire_bytes_per_frame=wire.n / len(wire_s),
        wire_frames_per_s=len(wire_s) / sum(wire_s))
    print(f"exporters: push over the wire p50 {res['push_wire_ms_p50']:.3f} "
          f"ms p99 {res['push_wire_ms_p99']:.3f} ms, ingest_frame in "
          f"process p50 {res['ingest_frame_ms_p50']:.3f} ms p99 "
          f"{res['ingest_frame_ms_p99']:.3f} ms; "
          f"{res['wire_bytes_per_frame']:.0f} wire bytes a frame, "
          f"{res['wire_frames_per_s']:.1f} frames/s", flush=True)
    return res


def phase_exporters(specs, events, device: str = "cuda") -> dict:
    """The record exporters, the agent's EXPORT=grpc process and
    FEDERATION_TARGET over the port's own gRPC transport (module
    docstring, `exporters`)."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        rec = _exp_records_part(events, tmp)
        child = _exp_child(tmp)
    fed = _exp_federation(specs, events, device)
    return {"phase": "exporters", "seconds": time.perf_counter() - t0,
            "record_exporters": rec, "grpc_child": child,
            "launches": fed.pop("launches"), "federation_target": fed}


#: `flp_pca` (a): the connections of the seeded synth pcap (two directions
#: each, so at least 2 * FLP_CONNS records), the replay window and the
#: agent's eviction period, and the step the patched clock takes a batch
FLP_CONNS = 12_000
FLP_EVICT_S = 0.1
FLP_SPAN_US = 2_400_000
FLP_CLOCK_STEP_S = 0.25
#: (c): the frames of the PCA pcap (PCA_FRAMES fit the packets agent's
#: queues, so none is shed)
PCA_FRAMES = 3_000
#: FLP_CONFIG of (a) (write grpc to %d) and, with a stdout writer, of (b)
FLP_CHIP_CFG = """
pipeline:
  - {name: f}
  - {name: n, follows: f}
  - {name: ct, follows: n}
  - {name: p, follows: ct}
  - {name: w, follows: p}
parameters:
  - name: f
    transform:
      type: filter
      filter:
        rules:
          - {type: keep_entry_if_exists, keepEntryField: SrcAddr}
          - {type: remove_field, removeField: DstMac}
  - name: n
    transform:
      type: network
      network:
        rules:
          - type: add_subnet
            add_subnet: {input: SrcAddr, output: SrcSubnet, parameters: /16}
          - type: decode_tcp_flags
            decode_tcp_flags: {input: Flags, output: FlagNames}
  - name: ct
    extract:
      type: conntrack
      conntrack:
        keyDefinition:
          fieldGroups:
            - {name: src, fields: [SrcAddr, SrcPort]}
            - {name: dst, fields: [DstAddr, DstPort]}
            - {name: common, fields: [Proto]}
          hash:
            fieldGroupRefs: [common]
            fieldGroupARef: src
            fieldGroupBRef: dst
        outputRecordTypes: [newConnection, endConnection]
        outputFields:
          - {name: Bytes, operation: sum, splitAB: true}
          - {name: Packets, operation: sum}
          - {name: numFlowLogs, operation: count}
        scheduling:
          - {endConnectionTimeout: 2s, terminatingTimeout: 500ms,
             heartbeatInterval: 30s}
        tcpFlags: {fieldName: Flags, detectEndConnection: true}
  - name: p
    encode:
      type: prom
      prom:
        prefix: flp_
        metrics:
          - {name: records_total, type: counter, labels: [_RecordType]}
          - {name: ended_bytes_total, type: counter, valueKey: Bytes_AB,
             filters: [{type: equal, key: _RecordType,
                        value: endConnection}]}
          - {name: flow_logs, type: histogram, valueKey: numFlowLogs,
             buckets: [1, 2, 4]}
  - name: w
    write: %s
"""


class _FlpClock:
    """`direct_flp`'s clock module with one patched `monotonic`, which
    moves FLP_CLOCK_STEP_S a batch: the agent's run and its replay see
    the same instants."""

    def __init__(self):
        self.t = 1000.0

    def __getattr__(self, name):
        return getattr(time, name)

    def monotonic(self) -> float:
        return self.t


def _flp_pcap(path: str) -> int:
    """FLP_CONNS seeded TCP connections of `scenarios/synth` frames over
    FLP_SPAN_US: a SYN, data and a FIN from the client, a SYN-ACK and
    data from the server; the pcap's frames."""
    import numpy as np
    from netobserv_tpu_torch.scenarios import synth
    rng = np.random.default_rng(25)
    pb = synth.PcapBuilder()
    for i in range(FLP_CONNS):
        cli = f"10.{(i >> 16) & 255}.{(i >> 8) & 255}.{i & 255}"
        srv = f"172.16.{i % 16}.{1 + i % 7}"
        sport, dport = 1024 + i % 50_000, int(rng.choice([80, 443, 8080]))
        t = i * FLP_SPAN_US // FLP_CONNS
        pb.add(t, cli, srv, 6, synth.tcp(sport, dport, 0x02), sport=sport,
               dport=dport)
        pb.add(t + 20, srv, cli, 6, synth.tcp(dport, sport, 0x12),
               sport=dport, dport=sport)
        for k in range(int(rng.integers(1, 4))):
            pb.add(t + 40 + k, cli, srv, 6, synth.tcp(sport, dport, 0x18)
                   + rng.bytes(int(rng.integers(0, 600))), sport=sport,
                   dport=dport)
        pb.add(t + 60, srv, cli, 6, synth.tcp(dport, sport, 0x18)
               + rng.bytes(int(rng.integers(0, 1400))), sport=dport,
               dport=sport)
        if i % 3:
            pb.add(t + 80, cli, srv, 6, synth.tcp(sport, dport, 0x11),
                   sport=sport, dport=dport)
    pb.write(path)
    return len(pb)


def _flp_samples(reg) -> list:
    return sorted((s.name, tuple(sorted(s.labels.items())), s.value)
                  for m in reg.collect() for s in m.samples
                  if s.name.startswith("flp_")
                  and not s.name.endswith("_created"))


def _flp_agent(tmp: str) -> dict:
    """`flp_pca` (a): the agent with EXPORT=direct-flp in process."""
    import os
    import queue
    import threading
    from netobserv_tpu_torch import config as tconfig
    from netobserv_tpu_torch.agent.agent import FlowsAgent
    from netobserv_tpu_torch.datapath.replay import PcapReplayFetcher
    from netobserv_tpu_torch.exporter import build_exporter, direct_flp
    from netobserv_tpu_torch.grpc.flow import start_flow_collector
    from netobserv_tpu_torch.metrics.registry import (
        Metrics, MetricsSettings, new_registry,
    )
    pcap = os.path.join(tmp, "flp.pcap")
    frames = _flp_pcap(pcap)
    srv_a, port_a, out_a = start_flow_collector(0)
    srv_b, port_b, out_b = start_flow_collector(0)
    clock, real = _FlpClock(), direct_flp._time
    direct_flp._time = clock
    grpc_w = "{type: grpc, grpc: {targetHost: 127.0.0.1, targetPort: %d}}"
    try:
        cfg = tconfig.load_config(environ={
            "EXPORT": "direct-flp",
            "CACHE_ACTIVE_TIMEOUT": f"{int(FLP_EVICT_S * 1000)}ms",
            "AGENT_IP": "127.0.0.1",
            "FLP_CONFIG": FLP_CHIP_CFG % (grpc_w % port_a)})
        cfg.validate()
        # `FlowsAgent.from_config` with DATAPATH=pcap:, which it reads from
        # this process's environment
        metrics = Metrics(MetricsSettings(prefix=cfg.metrics_prefix,
                                          level=cfg.metrics_level))
        exp = build_exporter(cfg, metrics=metrics)
        agent = FlowsAgent(cfg, PcapReplayFetcher(pcap, window_s=FLP_EVICT_S),
                           exp, metrics=metrics, agent_ip="127.0.0.1")
        batches, spent = [], [0.0]
        inner = exp.export_batch

        def export_batch(records):
            batches.append(list(records))
            clock.t += FLP_CLOCK_STEP_S
            t0 = time.perf_counter()
            inner(records)
            spent[0] += time.perf_counter() - t0
        exp.export_batch = export_batch
        stop = threading.Event()
        th = threading.Thread(target=agent.run, args=(stop,), daemon=True)
        t_run = time.perf_counter()
        th.start()
        deadline = time.monotonic() + 120
        while not agent.fetcher.exhausted():
            check(time.monotonic() < deadline, "the replay never ended")
            time.sleep(0.05)
        time.sleep(4 * FLP_EVICT_S)          # the last window's eviction
        stop.set()
        th.join(timeout=60)
        check(not th.is_alive(), "the agent outlived its stop")
        run_s = time.perf_counter() - t_run
        records = sum(len(b) for b in batches)
        check(records >= 2 * FLP_CONNS - 1000,
              f"{records} records from {FLP_CONNS} connections")
        got_a = []
        while True:
            try:
                got_a.append(out_a.get(timeout=2))
            except queue.Empty:
                break
        # the replay: the same batches, config and clock, on the CPU
        clock.t = 1000.0
        reg = new_registry()
        ref = direct_flp.DirectFLPExporter(
            flp_config=FLP_CHIP_CFG % (grpc_w % port_b), prom_registry=reg)
        for b in batches:
            clock.t += FLP_CLOCK_STEP_S
            ref.export_batch(b)
        ref.close()
        got_b = []
        while True:
            try:
                got_b.append(out_b.get(timeout=2))
            except queue.Empty:
                break
    finally:
        direct_flp._time = real
        srv_a.stop(None)
        srv_b.stop(None)
    wire_a = [m.SerializeToString() for m in got_a]
    wire_b = [m.SerializeToString() for m in got_b]
    check(wire_a == wire_b, f"the collector's {len(wire_a)} messages "
          f"differ from the replay's {len(wire_b)}")
    entries = sum(len(m.entries) for m in got_a)
    ours, theirs = _flp_samples(agent.metrics.registry), _flp_samples(reg)
    check(ours == theirs, "the agent's flp_ samples differ from the "
          "replay's")
    kinds = {dict(k).get("_RecordType"): v for n, k, v in ours
             if n == "flp_records_total"}
    check(kinds.get("newConnection", 0) >= FLP_CONNS - 500 and
          kinds.get("endConnection") == kinds.get("newConnection"),
          f"connection records {kinds}")
    check(entries == sum(kinds.values()),
          f"{entries} entries at the collector, {kinds} counted")
    res = {"pcap_frames": frames, "records": records,
           "batches": len(batches), "collector_messages": len(got_a),
           "collector_entries": entries, "records_total": kinds,
           "export_seconds": spent[0], "run_seconds": run_s,
           "records_per_s": records / spent[0],
           "entries_per_s": entries / spent[0]}
    print(f"flp_pca: (a) {records} records in {len(batches)} batches "
          f"through direct-flp at {res['records_per_s']:.0f} records/s "
          f"({res['entries_per_s']:.0f} connection entries/s out); the "
          f"collector got {entries} entries in {len(got_a)} messages, equal "
          "to the replay's", flush=True)
    return res


def _flp_child(tmp: str) -> dict:
    """`flp_pca` (b): EXPORT=direct-flp as a process with no DATAPATH."""
    import os
    mport = _free_port()
    proc, fo, fe = _agent_child(
        os.path.dirname(os.path.abspath(__file__)), {
            "EXPORT": "direct-flp",
            "FLP_CONFIG": FLP_CHIP_CFG % "{type: stdout}",
            "INTERFACES": "lo", "EXCLUDE_INTERFACES": "",
            "LISTEN_INTERFACES": "poll", "CACHE_ACTIVE_TIMEOUT": AE_CHILD_TICK,
            "METRICS_ENABLE": "true", "METRICS_SERVER_ADDRESS": "127.0.0.1",
            "METRICS_SERVER_PORT": str(mport)}, tmp, "flp_child")
    try:
        res = {"ladder_rung_expected": _expected_rung()[0],
               "start_to_started_s": _wait_started(
                   proc, f"http://127.0.0.1:{mport}")}
        res["sigterm_to_exit_s"] = _sigterm(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        fo.close()
        fe.close()
    with open(fe.name, "rb") as fh:
        err = fh.read().decode(errors="replace")
    check(proc.returncode == 0, f"EXPORT=direct-flp child: exit "
          f"{proc.returncode}, {err[-1500:]!r}")
    print(f"flp_pca: (b) EXPORT=direct-flp child Started in "
          f"{res['start_to_started_s']:.2f} s", flush=True)
    return res


def _pca_pcap(path: str) -> list:
    """PCA_FRAMES seeded UDP frames of `scenarios/synth`, 64 to 1,514
    bytes, 500 us apart; the frames."""
    import struct

    import numpy as np
    from netobserv_tpu_torch.scenarios import synth
    rng = np.random.default_rng(26)
    pb = synth.PcapBuilder()
    for i in range(PCA_FRAMES):
        pb.add(i * 500, "10.9.0.1", f"10.9.{1 + i % 200}.2", 17,
               synth.udp(40_000 + i % 1000, 5_000,
                         rng.bytes(int(rng.integers(22, 1473)))))
    pb.write(path)
    with open(path, "rb") as fh:
        data = fh.read()
    frames, off = [], 24
    while off < len(data):
        _s, _u, incl, _o = struct.unpack("<IIII", data[off:off + 16])
        frames.append(data[off + 16:off + 16 + incl])
        off += 16 + incl
    return frames


def _pca_leg(tmp: str, pcap: str, frames: list, tls: dict | None) -> dict:
    """`flp_pca` (c): an ENABLE_PCA child over `pcap` into the port's
    packet collector (over TLS with `tls`): the stream is the pcap file
    header, then each frame truncated at MAX_PAYLOAD_SIZE with its
    lengths. Its stamp is the file's offset (500 us a frame) rebased to
    the wall clock when the packet is read: the tracer reads the
    monotonic and the wall clock one after the other, so a thread switch
    between them shifts one stamp, and each rebased base lies between the
    child's start and the last packet's arrival."""
    import os
    import queue
    import struct
    from netobserv_tpu_torch.grpc.packet import start_packet_collector
    from netobserv_tpu_torch.model import binfmt
    from netobserv_tpu_torch.model.packet_record import pcap_file_header
    tls = tls or {}
    srv, port, out = start_packet_collector(
        0, tls_cert=tls.get("cert", ""), tls_key=tls.get("key", ""))
    name = "pca_tls" if tls else "pca"
    env = {"ENABLE_PCA": "true", "TARGET_HOST": "127.0.0.1",
           "TARGET_PORT": str(port), "DATAPATH": f"pcap:{pcap}"}
    if tls:
        env["TARGET_TLS_CA_CERT_PATH"] = tls["cert"]
    t0, wall0 = time.perf_counter(), time.time_ns() // 1000
    proc, fo, fe = _agent_child(
        os.path.dirname(os.path.abspath(__file__)), env, tmp, name)
    got, stamps = [], []
    try:
        while len(got) < len(frames) + 1:
            try:
                got.append(out.get(timeout=60))
            except queue.Empty:
                raise PhaseError(f"{name}: {len(got)} of {len(frames) + 1} "
                                 "messages, then nothing for 60 s")
            stamps.append(time.perf_counter())
        wall1 = time.time_ns() // 1000
        first_s = stamps[0] - t0
        res = {"start_to_header_s": first_s,
               "packets_per_s": len(frames) / (stamps[-1] - stamps[0]),
               "sigterm_to_exit_s": _sigterm(proc)}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        fo.close()
        fe.close()
        srv.stop(None)
    with open(fe.name, "rb") as fh:
        err = fh.read().decode(errors="replace")
    check(proc.returncode == 0, f"{name} child: exit {proc.returncode}, "
          f"{err[-1500:]!r}")
    check(out.empty(), f"{name}: more messages than frames")
    check(got[0] == pcap_file_header(), f"{name}: not the pcap file header")
    cap, bases, bad = binfmt.MAX_PAYLOAD_SIZE, [], []
    for i, (chunk, frame) in enumerate(zip(got[1:], frames)):
        n = min(len(frame), cap)
        sec, usec, incl, orig = struct.unpack("<IIII", chunk[:16])
        bases.append(sec * 1_000_000 + usec - 500 * i)
        if (incl, orig) != (n, n) or chunk[16:] != frame[:n]:
            bad.append(i)
    check(not bad, f"{name}: frames {bad[:5]} differ from the pcap's")
    check(wall0 <= min(bases) and max(bases) <= wall1,
          f"{name}: stamps off the wall clock: bases {min(bases)}-"
          f"{max(bases)} us outside the run's {wall0}-{wall1}")
    res["stamp_base_spread_us"] = max(bases) - min(bases)
    print(f"flp_pca: (c) {name}: {len(frames)} frames at "
          f"{res['packets_per_s']:.0f} packets/s, the stream equal to the "
          "pcap's header and frames, the stamps' rebased bases within "
          f"{res['stamp_base_spread_us']} us", flush=True)
    return res


def _pca_kernel() -> dict:
    """`flp_pca` (d): `load_packet_fetcher`; ENOSYS from bpf(2) is the
    one failure that marks the part not run."""
    import errno
    from netobserv_tpu_torch import config as tconfig
    from netobserv_tpu_torch.datapath.loader import load_packet_fetcher
    cfg = tconfig.load_config(environ={
        "ENABLE_PCA": "true", "TARGET_HOST": "127.0.0.1",
        "TARGET_PORT": "9"})
    try:
        fetcher = load_packet_fetcher(cfg)
    except OSError as exc:
        if exc.errno != errno.ENOSYS:
            raise
        print(f"flp_pca: (d) load_packet_fetcher not run: bpf(2) answers "
              f"{exc}", flush=True)
        return {"run": False, "error": f"OSError: {exc}"}
    try:
        kind = type(fetcher).__name__
        check(fetcher.read_packet(0.05) is None,
              "an unattached fetcher read a packet")
    finally:
        fetcher.close()
    print(f"flp_pca: (d) load_packet_fetcher took {kind}", flush=True)
    return {"run": True, "fetcher": kind}


def phase_flp_pca(specs) -> dict:
    """The embedded flowlogs-pipeline and packet capture (module
    docstring, `flp_pca`); host only, no kernel launches."""
    import tempfile
    t0 = time.perf_counter()
    for s in specs:
        s["kernel"].launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        res = {"phase": "flp_pca", "direct_flp": _flp_agent(tmp),
               "direct_flp_child": _flp_child(tmp)}
        pcap = f"{tmp}/pca.pcap"
        frames = _pca_pcap(pcap)
        res["pca"] = _pca_leg(tmp, pcap, frames, None)
        tls = _exp_tls_files(tmp)
        if tls is None:
            print("flp_pca: skip the PCA leg over TLS: no openssl on PATH "
                  "to make a certificate", flush=True)
            res["pca_tls"] = "skipped: no openssl on PATH"
        else:
            res["pca_tls"] = _pca_leg(tmp, pcap, frames, tls)
        res["pca_frames"] = len(frames)
    res["load_packet_fetcher"] = _pca_kernel()
    res["launches"] = {s["name"]: s["kernel"].launches for s in specs}
    check(not any(res["launches"].values()),
          f"flp_pca launched kernels: {res['launches']}")
    res["seconds"] = time.perf_counter() - t0
    return res


def phase_archive(specs, universe, pool, events) -> dict:
    """The archive and checkpoint planes on the card (module docstring's
    `archive`): the merge ladder captured first, then one lanes-path agent
    that checkpoints every roll and archives every window, ARC_WINDOWS
    windows of ARC_ROWS records closed by `flush()` while a folding thread
    and a range-query thread run beside it; then the checks and a
    restarted agent and aggregator."""
    import os
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch
    from netobserv_tpu_torch.archive import ArchiveStore, SketchArchive
    from netobserv_tpu_torch.archive import segment as aseg
    from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    from netobserv_tpu_torch.federation import delta as fdelta
    from netobserv_tpu_torch.federation.aggregator import (
        FederationAggregator,
    )
    from netobserv_tpu_torch.ops.hashing import base_hashes_multi_np
    from netobserv_tpu_torch.scenarios import traffic
    from netobserv_tpu_torch.sketch import carry
    from netobserv_tpu_torch.sketch import state as sk
    from netobserv_tpu_torch.utils import retrace, tracing
    try:
        from netobserv_tpu_torch.metrics.registry import Metrics
        metrics = Metrics()
    except ImportError:  # prometheus_client is optional
        metrics = None
    cfg = sk.SketchConfig()
    ev_all, lanes_all = LaneFeeder(events).stream
    n = len(events)
    ranks = np.concatenate([pool[i % n][1] for i in range(FOLDS_PER_WINDOW)])
    nbytes = ev_all["stats"]["bytes"].astype(np.float64)
    uni = traffic.event_universe(universe)
    per_pass = len(ev_all) // ARC_ROWS

    def rows(w: int) -> tuple[int, int]:
        lo = (w % per_pass) * ARC_ROWS
        return lo, lo + ARC_ROWS

    t_phase = time.perf_counter()
    retraces0 = retrace.total_retraces()
    root = tempfile.mkdtemp(prefix="chip_smoke_archive_")
    exp = exp2 = agg = agg2 = None
    errors: list = []
    stop = threading.Event()
    threads: list = []
    try:
        # the engine first: every ladder entry captured before any ring
        t0 = time.perf_counter()
        store = ArchiveStore(os.path.join(root, "archive"),
                             raw_windows=ARC_RAW, compact_group=ARC_GROUP,
                             max_levels=ARC_LEVELS, metrics=metrics)
        arch = SketchArchive(store, cfg, metrics=metrics,
                             agent_id="agent-0", ladder_max=ARC_LADDER)
        engine = arch.engine
        ladder_capture_s = time.perf_counter() - t0
        ladder = [e.captures for e in engine._entries.values()]
        check(engine.device.type == "cuda"
              and ladder == [1] * len(engine.ladder),
              f"ladder captures {ladder}")
        written: dict = {}
        write = arch.write_window
        write_spans: list = []

        def tap(host_tables, window, ts_ms):
            written[int(window)] = {k: np.array(v)
                                    for k, v in host_tables.items()}
            t0 = time.perf_counter()
            try:
                write(host_tables, window, ts_ms)
            finally:
                write_spans.append((t0, time.perf_counter()))
        arch.write_window = tap
        compactions: list = []
        engine.compact_once = _timed(engine.compact_once, compactions,
                                     when=bool)

        sink = WindowSink()
        exp = TorchSketchExporter(
            cfg, batch_size=BATCH, device="cuda", sink=sink,
            agent_id="agent-0", checkpoint_dir=os.path.join(root, "ck"),
            checkpoint_every=1, archive=arch, **LANES_KW)
        with exp._lock:
            exp._ensure_ring()  # its captures before any fold or thread
        captures0 = [c.captures for c in exp.captures]
        ck = exp._ckpt
        stage_spans, ck_write_spans, lock_spans = [], [], []
        ck.stage = _timed(ck.stage, stage_spans)
        ck._write = _timed(ck._write, ck_write_spans)
        exp._roll_locked = _timed(exp._roll_locked, lock_spans)
        for s in specs:
            s["kernel"].launches = 0

        # the folding thread: window w's evictions once window w - 1 rolled
        evict_spans: list = []
        fed = [threading.Event() for _ in range(ARC_WINDOWS)]

        def feeder():
            try:
                for w in range(ARC_WINDOWS):
                    while exp.rolls < w and not stop.is_set():
                        time.sleep(0.0005)
                    lo, hi = rows(w)
                    for a in range(lo, hi, EVICT_ROWS):
                        b = min(a + EVICT_ROWS, hi)
                        t0 = time.perf_counter()
                        exp.export_evicted(EvictedFlows(
                            ev_all[a:b],
                            **{k: v[a:b] for k, v in lanes_all.items()}))
                        evict_spans.append((t0, time.perf_counter()))
                    fed[w].set()
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(f"feeder: {type(e).__name__}: {e}")
                for ev in fed:
                    ev.set()

        # the range thread: raw, compacted and chained spans in turn
        ranges: dict = {"raw": [], "compacted": [], "chained": []}

        def spans_now():
            with engine.lock:
                segs = store.segments()
            out = []
            raw = [s for s in segs if s.level == 0][-4:]
            if raw:
                out.append(("raw", raw[0].window_from, raw[-1].window_to,
                            len(raw)))
            comp = [i for i, s in enumerate(segs) if s.level > 0]
            if comp:
                upto = min(comp[-1] + 2, len(segs) - 1)
                out.append(("compacted", segs[comp[0]].window_from,
                            segs[upto].window_to, upto - comp[0] + 1))
            if len(segs) > ARC_LADDER:
                out.append(("chained", segs[0].window_from,
                            segs[-1].window_to, len(segs)))
            return out

        def poller():
            try:
                while not stop.is_set():
                    for kind, lo, hi, _ in spans_now():
                        t0 = time.perf_counter()
                        code, body = exp.query_routes.handle(
                            "/query/range", {"from": str(lo), "to": str(hi)})
                        dt = time.perf_counter() - t0
                        if code != 200:
                            errors.append(f"range [{lo}, {hi}]: {code} "
                                          f"{body}")
                            continue
                        ranges[kind].append(
                            (dt, body["range"]["segments_merged"],
                             body["range"]["merge_dispatches"]))
                        stop.wait(ARC_POLL_PAUSE_S)
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(f"poller: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=f, name=f.__name__, daemon=True)
                   for f in (feeder, poller)]
        t_run = time.perf_counter()
        for t in threads:
            t.start()
        flush_ms = []
        for w in range(ARC_WINDOWS):
            check(fed[w].wait(timeout=120), f"window {w} was not fed")
            check(not errors, f"thread errors: {errors}")
            t0 = time.perf_counter()
            exp.flush()
            flush_ms.append((time.perf_counter() - t0) * 1e3)
        run_s = time.perf_counter() - t_run
        stop.set()
        for t in threads:
            t.join(timeout=60)
        check(not any(t.is_alive() for t in threads), "a thread hung")
        check(not errors, f"thread errors: {errors}")
        torch.cuda.synchronize()
        launches = {s["name"]: s["kernel"].launches for s in specs}
        want = _want_launches(specs, "lanes", exp.folds)
        check(launches == want, f"launches {launches}, want {want}")
        check([c.captures for c in exp.captures] == captures0,
              "the agent captured again")
        _watch_stats(exp)
        check(len(sink.reports) == ARC_WINDOWS and all(
            r["Records"] == ARC_ROWS for r in sink.reports),
            f"reports {[r['Records'] for r in sink.reports]}")
        check(sorted(written) == list(range(ARC_WINDOWS)),
              f"windows written {sorted(written)}")

        # retention: compactions ran, and the top level dropped its oldest
        segs = store.segments()
        levels = sorted({s.level for s in segs})
        check(compactions and levels == list(range(ARC_LEVELS + 1))
              and segs[0].window_from > 0 and len(segs) > ARC_LADDER,
              f"levels {levels}, {len(compactions)} compactions, first "
              f"window {segs[0].window_from}, {len(segs)} segments")
        # every segment decodes with the right header
        decode_ms = []
        decoded = []
        for s in segs:
            data = store.read(s)
            t0 = time.perf_counter()
            seg = aseg.decode_segment(data)
            decode_ms.append((time.perf_counter() - t0) * 1e3)
            check((seg.agent_id, seg.level, seg.window_from, seg.window_to,
                   seg.n_windows, seg.dims) == (
                "agent-0", s.level, s.window_from, s.window_to,
                s.window_to - s.window_from + 1, engine.dims)
                and seg.ts_ms > 0, f"segment {s.name} header")
            decoded.append(seg.tables)
        t0 = time.perf_counter()
        enc = [aseg.encode_segment(written[ARC_WINDOWS - 1], agent_id="x",
                                   level=0, window_from=0, window_to=0,
                                   n_windows=1, ts_ms=0, dims=engine.dims)
               for _ in range(3)]
        encode_ms = (time.perf_counter() - t0) * 1e3 / 3

        # raw ranges bit-exact: the last raw segments (one dispatch), three
        # of them (padded to 4), and every segment (chained)
        raw = [i for i, s in enumerate(segs) if s.level == 0]
        cases = {"raw": raw[-5:], "padded": raw[-3:],
                 "chained": list(range(len(segs)))}
        exact = {}
        for name, idx in cases.items():
            tabs = [decoded[i] for i in idx]
            with engine.lock:
                _, merged, n_disp = engine.merge_tables_host(tabs)
            if name != "chained":
                # raw segments hold the archived windows' tables exactly
                for i in idx:
                    for k, v in written[segs[i].window_from].items():
                        check(np.array_equal(decoded[i][k],
                                             np.asarray(v, decoded[i][k]
                                                        .dtype)),
                              f"segment {segs[i].name}: {k} differs from "
                              "the window's tables")
            acc = _chain_replay(engine, tabs)
            for k in (*FED_ADDED, *FED_MAXED):
                check(merged[k].dtype == acc[k].dtype
                      and np.array_equal(merged[k], acc[k]),
                      f"{name}: {k} differs from the numpy replay")
            eager = _replay_ladder(engine, tabs, cfg)
            diff = [k for k in eager if not np.array_equal(
                np.asarray(eager[k], merged[k].dtype), merged[k])]
            check(not diff, f"{name}: the captured ladder differs from the "
                  f"eager replay in {diff}")
            exact[name] = {"segments": len(idx), "dispatches": n_disp,
                           "heavy_valid": int(merged["heavy_valid"].sum())}

        # a compacted range within the widened CM bars
        comp = [i for i, s in enumerate(segs) if s.level > 0]
        lo_w, hi_w = segs[comp[0]].window_from, segs[comp[-1]].window_to
        snap = engine.range_snapshot(lo_w, hi_w)
        check(snap["range"]["compacted"], "the range has no super-window")
        cm = snap["cm_bytes"]
        d, width = cm.shape
        windows = range(lo_w, hi_w + 1)
        exact_sum = sum(written[w]["cm_bytes"].astype(np.float64)
                        for w in windows)
        tol = (len(windows) - 1) * U * exact_sum
        check(bool(np.all(np.abs(cm - exact_sum) <= tol)),
              "compacted CM planes differ from the windows' sum past the "
              "add-order bound")
        true = np.zeros(len(uni))
        n_rows = 0
        for w in windows:
            a, b = rows(w)
            true += np.bincount(ranks[a:b], weights=nbytes[a:b],
                                minlength=len(uni))
            n_rows += b - a
        h = base_hashes_multi_np(uni)
        with np.errstate(over="ignore"):
            idx = (h["h1"][:, None] + np.arange(d, dtype=np.uint32)
                   * h["h2"][:, None]) & np.uint32(width - 1)
        est = cm[np.arange(d)[None, :], idx].min(axis=1).astype(np.float64)
        bound = np.e / width * float(np.sum(cm[0], dtype=np.float64))
        slack = 2 * n_rows * U
        keys = np.flatnonzero(true)
        lo_ok = est[keys] >= true[keys] * (1 - slack)
        hi_ok = est[keys] <= (true[keys] + bound) * (1 + slack)
        check(bool(lo_ok.all() and hi_ok.all()),
              f"{int((~lo_ok).sum())} keys under, {int((~hi_ok).sum())} "
              f"over the widened CM bars")
        bars = {"windows": [lo_w, hi_w], "keys": int(len(keys)),
                "bound_bytes": bound,
                "max_over_true_bytes": float(np.max(est[keys] - true[keys]))}

        # the roll's lock hold with the archive and checkpoint on and off
        # (empty windows)
        hold_on, hold_off = [], []
        for _ in range(ARC_ROLL_PAIRS):
            for on, out in ((True, hold_on), (False, hold_off)):
                exp._archive = arch if on else None
                exp._ckpt_every = 1 if on else 0
                before = len(lock_spans)
                exp.flush()
                out.append(_ms(lock_spans[before:])[-1])
        exp._archive, exp._ckpt_every = arch, 1

        # folds while compactions run: a thread folds the lanes stream's
        # evictions into the open window while this thread archives
        # ARC_CONTEND more windows (copies of archived tables, window ids
        # from 1000) straight through the archive, landing compactions
        contend_spans, done = [], threading.Event()

        def folder():
            try:
                a = 0
                while not done.is_set():
                    b = min(a + EVICT_ROWS, len(ev_all))
                    t0 = time.perf_counter()
                    exp.export_evicted(EvictedFlows(
                        ev_all[a:b],
                        **{k: v[a:b] for k, v in lanes_all.items()}))
                    contend_spans.append((t0, time.perf_counter()))
                    a = b % len(ev_all)
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(f"folder: {type(e).__name__}: {e}")
        threads = [threading.Thread(target=folder, daemon=True)]
        threads[0].start()
        n_comp = len(compactions)
        for i in range(ARC_CONTEND):
            write(written[i], 1000 + i, 1)
        done.set()
        threads[0].join(timeout=60)
        check(not threads[0].is_alive() and not errors,
              f"folder: {errors}")
        check([c.captures for c in exp.captures] == captures0,
              "the agent captured again")
        contended = compactions[n_comp:]
        check(len(contended) >= ARC_CONTEND // ARC_GROUP,
              f"{len(contended)} compactions while folding")
        during = [b - a for a, b in contend_spans if any(
            a < c1 and b > c0 for c0, c1 in contended)]
        apart = [b - a for a, b in contend_spans if not any(
            a < c1 and b > c0 for c0, c1 in contended)]
        check(bool(during), "no fold overlapped a compaction")

        # the ladder's device time: CUDA events over replays of x1 and x16
        merge_ms = {}
        for k in (1, ARC_LADDER):
            with exp._lock:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(REPS // 5):
                    engine._entries[k].graph.replay()
                end.record()
                torch.cuda.synchronize()
            merge_ms[f"x{k}"] = start.elapsed_time(end) / (REPS // 5)
        for k, e in engine._entries.items():
            st = e.stats()
            check(e.captures == 1 and st["retraces"] == 0,
                  f"archive_merge_x{k} {st}")
            WATCHED.append(st)

        # a restarted agent restores the last checkpoint in place
        exp.close()
        saved = carry.state_to_numpy(exp.state)
        t0 = time.perf_counter()
        exp2 = TorchSketchExporter(
            cfg, batch_size=BATCH, device="cuda", sink=_discard,
            agent_id="agent-0", checkpoint_dir=os.path.join(root, "ck"),
            **LANES_KW)
        restore_s = time.perf_counter() - t0
        got = carry.state_to_numpy(exp2.state)
        check(all(np.array_equal(got[k], saved[k]) for k in saved),
              "the restarted agent's state differs from its checkpoint")
        ptrs = [carry.get_leaf(exp2.state, p).data_ptr()
                for p in carry.field_paths()]
        t0 = time.perf_counter()
        exp2._maybe_restore()
        torch.cuda.synchronize()
        restore_in_place_ms = (time.perf_counter() - t0) * 1e3
        check(ptrs == [carry.get_leaf(exp2.state, p).data_ptr()
                       for p in carry.field_paths()]
              and int(exp2.state.window) == ARC_WINDOWS + 2 * ARC_ROLL_PAIRS
              + 1, "the restore moved a tensor or lost the window")

        # a restarted aggregator restores its state and ledger in place
        agg_dir = os.path.join(root, "agg")
        agg = FederationAggregator(cfg, window_s=3600.0,
                                   checkpoint_dir=agg_dir, sink=_discard)
        frames = [fdelta.encode_frame(
            written[w], agent_id=f"agent-{w}", window=0, ts_ms=0,
            dims=engine.dims, agent_epoch=7, frame_uuid=f"u{w}")
            for w in (0, 1)]
        for f in frames:
            check(agg.ingest_frame(f).accepted == 1, "frame refused")
        agg.flush()
        agg_saved = sk.state_tables(agg._state)
        ledger = {k: dict(v) for k, v in agg._ledger.items()}
        agg.kill()
        agg = None  # killed: no final flush into agg2's directory
        t0 = time.perf_counter()
        agg2 = FederationAggregator(cfg, window_s=3600.0,
                                    checkpoint_dir=agg_dir, sink=_discard)
        agg_restore_s = time.perf_counter() - t0
        agg_got = sk.state_tables(agg2._state)
        check(all(np.array_equal(agg_got[k], agg_saved[k])
                  for k in agg_saved) and agg2._ledger == ledger
              and agg2._window_host == 1 and agg2._fold.captures == 1,
              "the restarted aggregator differs from its checkpoint")
        ack = agg2.ingest_frame(frames[0])
        check(ack.accepted == 1 and ack.duplicate == 1,
              f"a redelivered frame after the restart: {ack}")
        check(retrace.total_retraces() == retraces0,
              f"{retrace.total_retraces() - retraces0} retraces")
        stages, writes = _ms(stage_spans), _ms(ck_write_spans)
        compaction_ms = _ms(compactions)
        busy = sorted(b - a for a, b in evict_spans)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        for x in (exp, exp2):
            if x is not None:
                x.close()
        for x in (agg, agg2):
            if x is not None:
                x.close()
        tracing.configure(sample=0.0)
        shutil.rmtree(root, ignore_errors=True)

    def pct(kind):
        dts = [r[0] * 1e3 for r in ranges[kind]]
        return {"n": len(dts), "p50_ms": _pct(dts, 50),
                "p99_ms": _pct(dts, 99),
                "segments": sorted({r[1] for r in ranges[kind]}),
                "dispatches": sorted({r[2] for r in ranges[kind]})}
    return {"phase": "archive", "windows": ARC_WINDOWS,
            "records_per_window": ARC_ROWS,
            "archive": {"raw_windows": ARC_RAW, "compact_group": ARC_GROUP,
                        "max_levels": ARC_LEVELS, "ladder_max": ARC_LADDER},
            "ladder_capture_s": ladder_capture_s,
            "segments": len(segs), "levels": levels,
            "first_window_kept": segs[0].window_from,
            "segment_raw_bytes": sum(v.nbytes for v in written[0].values()),
            "segment_zlib_bytes": len(enc[0]),
            "segment_encode_ms": encode_ms,
            "segment_decode_ms_p50": _pct(decode_ms, 50),
            "segment_decode_ms_max": max(decode_ms),
            "archive_write_ms_p50": _pct(_ms(write_spans), 50),
            "archive_write_ms_max": max(_ms(write_spans)),
            "compactions": len(compaction_ms),
            "compaction_ms_p50": _pct(compaction_ms, 50),
            "compaction_ms_max": max(compaction_ms),
            "merge_graph_event_ms": merge_ms,
            "range": {k: pct(k) for k in ranges},
            "exact": exact, "compacted_bars": bars,
            "roll_lock_hold_ms_with_archive_and_ckpt": hold_on,
            "roll_lock_hold_ms_without": hold_off,
            "roll_lock_hold_ms_live_p50": _pct(_ms(lock_spans), 50),
            "ckpt_stage_ms_p50": _pct(stages, 50),
            "ckpt_stage_ms_max": max(stages),
            "ckpt_write_ms_p50": _pct(writes, 50),
            "ckpt_write_ms_max": max(writes),
            "agent_restore_s": restore_s,
            "agent_restore_in_place_ms": restore_in_place_ms,
            "aggregator_restore_s": agg_restore_s,
            "flush_ms_p50": _pct(flush_ms, 50), "flush_ms_max": max(flush_ms),
            "export_evicted_ms_p50": _pct(busy, 50) * 1e3,
            "export_evicted_ms_max": busy[-1] * 1e3,
            "contended": {
                "compactions": len(contended),
                "export_evicted": len(during) + len(apart),
                "during_compaction_ms_max": max(during) * 1e3,
                "during_compaction_ms_p50": _pct(during, 50) * 1e3,
                "apart_ms_max": max(apart) * 1e3 if apart else None,
                "apart_ms_p50": _pct(apart, 50) * 1e3 if apart else None},
            "run_s": run_s,
            "seconds": time.perf_counter() - t_phase,
            "launches": launches}


#: the overload phase: the evictions of its exactness steps, the overdrive's
#: seconds and window, the wedge's slot-wait budget and spin, and the sync
#: run's seconds beside the overdrive
OV_EVICTIONS = 16
OV_DRIVE_S = 6.0
OV_WINDOW_S = 1.0
OV_SYNC_S = 2.0
OV_BUDGET_S = 0.25
OV_SPIN_S = 2.0


class NeverReady:
    """A slot's copy event that never completes: the stand-in that drops
    the overload replay's folds where the timed run's budget tripped."""

    def query(self) -> bool:
        return False

    def synchronize(self) -> None:
        raise PhaseError("a budgeted slot wait synchronized")


def _integer_stream(events):
    """The lanes stream with every summed mass an integer small enough that
    no per-cell f32 sum of the phase passes 2^24 (bytes 1-63, packets
    1-3, drop bytes 0-63 and packets 0-3, unsampled): add order then
    cannot change a bit, and captured, eager and plain folds agree
    exactly."""
    ev_all, lanes_all = LaneFeeder(events).stream
    ev = ev_all.copy()
    st = ev["stats"]
    st["bytes"] = 1 + st["bytes"] % 63
    st["packets"] = 1 + st["packets"] % 3
    st["sampling"] = 0
    lanes = dict(lanes_all)
    if "drops" in lanes:
        drops = lanes["drops"].copy()
        drops["bytes"] %= 64
        drops["packets"] %= 4
        lanes["drops"] = drops
    return ev, lanes


def _health(sup) -> dict:
    """The health source of the reference agent's `health_snapshot`
    (`agent/agent.py:239-255`), written here over a supervisor that no
    agent owns (the overload phase drives the exporter alone)."""
    conditions = sup.conditions()
    return {"status": "Started", "degraded": sup.degraded,
            "overloaded": bool(conditions.get("overloaded", {})
                               .get("active")),
            "conditions": conditions, "stages": sup.snapshot()}


def _http_json(url: str) -> tuple:
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _spin_cycles(seconds: float) -> int:
    """Cycles of `torch.cuda._sleep` (a test tool of torch's, no port of a
    kernel) that hold the current stream about `seconds`, from a timed
    probe."""
    import torch
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    probe = 50_000_000
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(probe)
    end.record()
    end.synchronize()
    return int(probe * seconds * 1e3 / start.elapsed_time(end))


def phase_overload(specs, universe, pool, events, card: str) -> dict:
    """Overload control on the card (module docstring's `overload`): the
    unshedded exporters alike, a pinned shed against its plain replay and
    the exact oracle, an overdrive under the port's supervisor and metrics
    server with recovery, a wedged stream against the slot-wait budget,
    and the supervised threads' restarts."""
    import threading

    import numpy as np
    import torch
    from netobserv_tpu_torch.agent.supervisor import Supervisor
    from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    from netobserv_tpu_torch.federation import delta as fdelta
    from netobserv_tpu_torch.metrics.registry import Metrics
    from netobserv_tpu_torch.ops.hashing import base_hashes_multi_np
    from netobserv_tpu_torch.scenarios import traffic
    from netobserv_tpu_torch.sketch import staging
    from netobserv_tpu_torch.sketch import state as sk
    from netobserv_tpu_torch.utils import faultinject, retrace
    cfg = sk.SketchConfig()
    t_phase = time.perf_counter()
    real = LaneFeeder(events).stream
    ints = _integer_stream(events)
    n_rows = len(real[0])
    gen = _stream_evictions(n_rows)
    cuts = [next(gen) for _ in range(OV_EVICTIONS)]

    def eviction(stream, lo, hi):
        ev, lanes = stream
        return EvictedFlows(ev[lo:hi],
                            **{k: v[lo:hi] for k, v in lanes.items()})

    def settled(exp) -> dict:
        """The exporter's tables once its handoff and pending rows
        folded."""
        exp._drain_handoff()
        with exp._lock:
            exp._drain_pending()
        return exp.state_tables()

    def same(a: dict, b: dict) -> bool:
        return a.keys() == b.keys() and all(
            np.array_equal(a[k], b[k]) for k in a)

    out = {"phase": "overload", "card": card}
    retraces0 = retrace.total_retraces()

    # 1. no controller, an idle one, and an idle one behind the overlap
    tabs = {}
    for name, kw in (("disabled", {}), ("idle", {"shed_watermark": 1e9}),
                     ("overlap_idle", {"shed_watermark": 1e9,
                                       "overlap_depth": 2})):
        exp = TorchSketchExporter(cfg, batch_size=BATCH, device="cuda",
                                  sink=_discard, **LANES_KW, **kw)
        try:
            if name == "disabled":
                check(exp._overload is None and exp._handoff is None,
                      "a disabled exporter made a controller or thread")
            for lo, hi in cuts:
                exp.export_evicted(eviction(ints, lo, hi))
            tabs[name] = settled(exp)
            if exp._overload is not None:
                check(exp.ring.slot_wait_budget_s == 30.0
                      and exp._overload.shed_rows == 0,
                      f"idle controller {exp.overload_snapshot()}")
        finally:
            exp.close()
    check(same(tabs["disabled"], tabs["idle"])
          and same(tabs["disabled"], tabs["overlap_idle"]),
          "an idle controller or the overlap changed the tables")
    out["unshedded_equal"] = sorted(tabs)

    # 2. a shed pinned at 4 (shed_seed=1): captured against its plain
    # replay bit for bit (integer masses), and against the unshed run and
    # the exact oracle within the reference test's budget
    def pinned(exp, factor):
        ctl = exp._overload
        ctl.shed = factor
        ctl.update = lambda *a, **k: factor

    shed_kw = {"shed_watermark": 0.5, "shed_max": 4, "shed_seed": 1}
    runs = {}
    for name in ("unshed", "shed", "shed_plain"):
        ctx = plain_versions(specs) if name == "shed_plain" else \
            contextlib.nullcontext()
        with ctx:
            exp = TorchSketchExporter(
                cfg, batch_size=BATCH, device="cuda", sink=_discard,
                capture=name != "shed_plain", **LANES_KW,
                **({} if name == "unshed" else shed_kw))
            try:
                if name != "unshed":
                    pinned(exp, 4)
                for lo, hi in cuts:
                    exp.export_evicted(eviction(ints, lo, hi))
                runs[name] = (settled(exp), exp.overload_snapshot())
            finally:
                exp.close()
    (unshed, _), (shed, snap), (shed_plain, snap_plain) = (
        runs["unshed"], runs["shed"], runs["shed_plain"])
    check(same(shed, shed_plain) and snap == snap_plain,
          "the captured shed differs from its plain replay")
    check(snap["shed_rows"] > 0, f"the pinned run shed nothing: {snap}")
    ranks = np.concatenate([pool[i % len(pool)][1]
                            for i in range(FOLDS_PER_WINDOW)])
    uni = traffic.event_universe(universe)
    nb = ints[0]["stats"]["bytes"].astype(np.float64)
    exact = np.zeros(len(uni))
    sq = np.zeros(len(uni))
    for lo, hi in cuts:
        exact += np.bincount(ranks[lo:hi], weights=nb[lo:hi],
                             minlength=len(uni))
        sq += np.bincount(ranks[lo:hi], weights=nb[lo:hi] ** 2,
                          minlength=len(uni))
    top = np.argsort(-exact, kind="stable")[:12]
    h = base_hashes_multi_np(uni[top])
    d, width = cfg.cm_depth, cfg.cm_width
    with np.errstate(over="ignore"):
        idx = (h["h1"][:, None] + np.arange(d, dtype=np.uint32)
               * h["h2"][:, None]) & np.uint32(width - 1)

    def est(tables):
        cm = np.asarray(tables["cm_bytes"], np.float64)
        return cm[np.arange(d)[None, :], idx].min(axis=1)

    est_a, est_b = est(unshed), est(shed)
    total = float(exact.sum())
    tol = 2 * np.e * total / width + 4 * np.sqrt((4 - 1) * sq[top])
    diff = np.abs(est_b - est_a)
    check(bool((diff <= tol).all()),
          f"shed estimates off the unshed run: {diff.tolist()} > "
          f"{tol.tolist()}")
    rel = (est_b - est_a) / np.maximum(est_a, 1.0)
    check(abs(float(rel.mean())) <= 0.15,
          f"mean relative deviation {rel.mean():+.3f}")

    def recall(tables):
        got = {tuple(w) for w, v in zip(np.asarray(tables["heavy_words"],
                                                   np.uint32),
                                        np.asarray(tables["heavy_valid"]))
               if v}
        return sum(tuple(uni[t]) in got for t in top[:8]) / 8

    rec_a, rec_b = recall(unshed), recall(shed)
    check(rec_b >= rec_a - 0.25, f"shed recall {rec_b} against {rec_a}")
    out["pinned_shed"] = {
        "factor": 4, "evictions": len(cuts),
        "rows": sum(hi - lo for lo, hi in cuts),
        "shed_rows": snap["shed_rows"], "shed_batches": snap["shed_batches"],
        "captured_equals_plain": True,
        "top12_abs_diff_over_tol_max": float((diff / tol).max()),
        "mean_rel_dev": float(rel.mean()),
        "recall_top8_unshed": rec_a, "recall_top8_shed": rec_b}

    # 3. the overdrive: a producer as fast as export_evicted returns, the
    # overlap and the controller under the port's supervisor and server
    metrics = Metrics()
    sink = WindowSink()
    frames: list = []
    sup = Supervisor(metrics=metrics, check_period_s=0.1)
    exp = TorchSketchExporter(
        cfg, batch_size=BATCH, device="cuda", window_s=OV_WINDOW_S,
        sink=sink, metrics=metrics, delta_sink=frames.append,
        shed_watermark=2.0, shed_max=64, overlap_depth=2, **LANES_KW)
    srv = None
    thread_errors: list = []
    hook = threading.excepthook
    threading.excepthook = lambda a: thread_errors.append(
        f"{a.thread.name if a.thread else '?'}: {a.exc_type.__name__}: "
        f"{a.exc_value}")
    try:
        exp.register_supervised(sup, heartbeat_timeout_s=10.0,
                                backoff_initial_s=0.1, backoff_max_s=0.5)
        sup.start()
        srv = exp.serve(health_source=lambda: _health(sup))
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        captures0 = [c.captures for c in exp.captures]
        for s in specs:
            s["kernel"].launches = 0
        folds0, rolls0 = exp.folds, exp.rolls
        ctl = exp._overload
        put_ms: list = []
        offered = [0]
        stop = threading.Event()
        most_pending = [0]

        def produce():
            g = _stream_evictions(n_rows)
            while not stop.is_set():
                lo, hi = next(g)
                t0 = time.perf_counter()
                exp.export_evicted(eviction(real, lo, hi))
                put_ms.append((time.perf_counter() - t0) * 1e3)
                offered[0] += hi - lo

        producer = threading.Thread(target=produce, name="ov-producer")
        t0 = time.perf_counter()
        producer.start()
        factors, busy, waits = [], [], []
        healthz = readyz = None
        cond_seen = False
        # the drive, held on (at most 3 s) until the factor is above 1,
        # so that the recovery starts from a shed
        while time.perf_counter() - t0 < OV_DRIVE_S or (
                ctl.shed == 1 and time.perf_counter() - t0 < OV_DRIVE_S + 3):
            time.sleep(0.01)
            factors.append((time.perf_counter(), ctl.shed))
            busy.append(ctl.last_busy)
            waits.append(exp.ring.slot_wait_p95())
            most_pending[0] = max(most_pending[0], exp.pending.n)
            if ctl.shed > 1 and not cond_seen:
                cond = sup.conditions().get("overloaded", {})
                if cond.get("active"):
                    code, body = _http_json(base + "/healthz")
                    if code == 200 and body.get("overloaded") is True and \
                            body["conditions"]["overloaded"]["active"]:
                        cond_seen = True
                        healthz = {"code": code, "shed_factor": body[
                            "conditions"]["overloaded"]["shed_factor"]}
                        readyz = _http_json(base + "/readyz")[0]
        stop.set()
        shed_at_stop = ctl.shed
        producer.join(timeout=30)
        check(not producer.is_alive(), "the producer did not stop")
        t_stop = time.perf_counter()
        drive_s = t_stop - t0
        exp._drain_handoff()
        snap_drive = exp.overload_snapshot()
        admitted = offered[0] - snap_drive["shed_rows"]
        # recovery: the factor at 1 within one clean window after the stop
        rolls_stop = exp.rolls
        deadline = t_stop + 3 * OV_WINDOW_S + 1.0
        while ctl.shed > 1 and time.perf_counter() < deadline:
            time.sleep(0.01)
        recovered_s = time.perf_counter() - t_stop
        recover_windows = exp.rolls - rolls_stop
        check(ctl.shed == 1, f"factor {ctl.shed} {recovered_s:.2f} s after "
              "the producer stopped")
        check(recover_windows <= 2, f"recovery took {recover_windows} "
              "window rolls (one clean window: at most 2)")
        exp.flush()
        torch.cuda.synchronize()
        launches = {s["name"]: s["kernel"].launches for s in specs}
        folds = exp.folds - folds0
        captures1 = [c.captures for c in exp.captures]
        watch = _watch_stats(exp)
        max_factor = max(f for _, f in factors)
        above = sum(b - a for (a, fa), (b, _) in zip(factors, factors[1:])
                    if fa > 1)
        check(max_factor > 1, "the overdrive never raised the factor")
        check(cond_seen and readyz == 200,
              f"overloaded condition over /healthz {healthz}, /readyz "
              f"{readyz}")
        check(most_pending[0] <= exp.pending.capacity,
              f"pending {most_pending[0]} past {exp.pending.capacity}")
        reps = sink.reports
        check([r["Window"] for r in reps] == list(range(exp.rolls))
              and exp.reports_published == exp.rolls
              and exp.reports_shed == 0,
              f"windows {[r['Window'] for r in reps]}, {exp.rolls} rolls, "
              f"{exp.reports_shed} shed")
        tel = [fdelta.decode_frame(f).telemetry for f in frames]
        check(any(t["shed_factor"] > 1 and "OVERLOADED" in t["conditions"]
                  for t in tel), f"no frame carried the overload: {tel}")
        check(captures1 == captures0
              and retrace.total_retraces() == retraces0,
              f"captures {captures1} (was {captures0}), retraces "
              f"{retrace.total_retraces() - retraces0}")
        check(all(w["compiles"] == (1 if _warm_captured(w["fn"]) else 0)
                  and w["retraces"] == 0 for w in watch),
              f"captured folds {watch}")
        check(exp.ingest_errors == 0 and not thread_errors,
              f"{exp.ingest_errors} ingest errors, threads {thread_errors}")
        want = _want_launches(specs, "lanes", folds)
        check(launches == want, f"launches {launches}, want {want}")
        out["overdrive"] = {
            "seconds": drive_s, "window_s": OV_WINDOW_S,
            "offered_records_per_s": offered[0] / drive_s,
            "admitted_records_per_s": admitted / drive_s,
            "shed_factor_max": max_factor, "seconds_above_1": above,
            "shed_rows": snap_drive["shed_rows"],
            "shed_batches": snap_drive["shed_batches"],
            "busy_ewma_p50": _pct(busy, 50), "busy_ewma_max": max(busy),
            "slot_wait_p95_max_s": max(waits),
            "export_evicted_overlap_ms": {
                "p50": _pct(put_ms, 50), "p99": _pct(put_ms, 99),
                "max": max(put_ms), "n": len(put_ms)},
            "pending_max": most_pending[0],
            "healthz": healthz, "readyz": readyz,
            "windows": exp.rolls, "shed_factor_at_stop": shed_at_stop,
            "recover_seconds": recovered_s,
            "recover_windows": recover_windows,
            "frames_overloaded": sum("OVERLOADED" in t["conditions"]
                                     for t in tel),
            "folds": folds}
        out["launches"] = launches

        # 5. supervision: the fold thread killed (tests/test_overlap.py),
        # then a window-thread crash at `sketch.window_timer`
        restarts = metrics.stage_restarts_total
        exp._closed.set()
        exp._fold_thread.join(timeout=5)
        exp._closed.clear()
        check(not exp._fold_thread.is_alive(), "the fold thread lives on")
        for lo, hi in cuts[:2]:
            exp.export_evicted(eviction(real, lo, hi))
        t1 = time.perf_counter()
        while (exp._handoff.unfinished_tasks
               or restarts.labels("sketch-fold")._value.get() < 1) and \
                time.perf_counter() - t1 < 15:
            time.sleep(0.01)
        fold_restart_s = time.perf_counter() - t1
        check(exp._handoff.unfinished_tasks == 0
              and restarts.labels("sketch-fold")._value.get() >= 1,
              "the supervisor did not revive the fold thread")
        t1 = time.perf_counter()
        while (restarts.labels("sketch-window")._value.get() < 1
               or not exp._timer.is_alive()) and \
                time.perf_counter() - t1 < 15:
            time.sleep(0.01)  # the kill stopped the window thread too
        win0 = restarts.labels("sketch-window")._value.get()
        check(win0 >= 1 and exp._timer.is_alive(),
              "the supervisor did not revive the window thread")
        with exp._lock:  # a queued report, and the thread's crash armed
            queued = exp._close_window_locked()
            faultinject.arm("sketch.window_timer", "crash", times=1)
        # wait for the sink itself: `out` is set before the query snapshot
        # and the sink call, so a poll between them saw no report there
        queued_win = int(queued.report.window)
        t1 = time.perf_counter()
        while (restarts.labels("sketch-window")._value.get() < win0 + 1
               or queued_win not in [r["Window"] for r in sink.reports]) \
                and time.perf_counter() - t1 < 15:
            time.sleep(0.01)
        faultinject.clear("sketch.window_timer")
        window_restart_s = time.perf_counter() - t1
        wins = [r["Window"] for r in sink.reports]
        check(queued.out is not None
              and wins.count(queued_win) == 1
              and len(wins) == len(set(wins)),
              f"the queued window {queued_win} published "
              f"{wins.count(queued_win)} times: {wins}")
        check(restarts.labels("sketch-window")._value.get() >= win0 + 1,
              "no window thread restart")
        thread_errors[:] = [e for e in thread_errors
                            if "FaultInjected" not in e]
        check(not thread_errors, f"thread errors {thread_errors}")
        out["supervision"] = {
            "fold_restart_s": fold_restart_s,
            "window_restart_s": window_restart_s,
            "stage_restarts": {s: restarts.labels(s)._value.get()
                               for s in ("sketch-fold", "sketch-window")}}

    finally:
        threading.excepthook = hook
        faultinject.clear()
        sup.stop()
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        exp.close()

    # the same feed synchronously: export_evicted without the overlap
    # (the overdrive's exporter closed first: its window thread's rolls
    # must not run beside this ring's captures, ROADMAP C4)
    exp_sync = TorchSketchExporter(
        cfg, batch_size=BATCH, device="cuda", sink=_discard,
        shed_watermark=2.0, shed_max=64, **LANES_KW)
    try:
        with exp_sync._lock:
            exp_sync._ensure_ring()
        sync_ms, sync_shed = [], 1
        g = _stream_evictions(n_rows)
        t1 = time.perf_counter()
        while time.perf_counter() - t1 < OV_SYNC_S:
            lo, hi = next(g)
            t2 = time.perf_counter()
            exp_sync.export_evicted(eviction(real, lo, hi))
            sync_ms.append((time.perf_counter() - t2) * 1e3)
            sync_shed = max(sync_shed, exp_sync._overload.shed)
        out["overdrive"]["export_evicted_sync_ms"] = {
            "p50": _pct(sync_ms, 50), "p99": _pct(sync_ms, 99),
            "max": max(sync_ms), "n": len(sync_ms),
            "shed_factor_max": sync_shed}
    finally:
        exp_sync.close()

    # 4. a wedged stream: a spin of about OV_SPIN_S on the exporter's
    # stream between folds, the slot-wait budget at OV_BUDGET_S
    metrics = Metrics()
    cycles = _spin_cycles(OV_SPIN_S)
    exp = TorchSketchExporter(cfg, batch_size=BATCH, device="cuda",
                              sink=_discard, metrics=metrics,
                              shed_watermark=1e9,
                              shed_slot_budget_s=OV_BUDGET_S, **LANES_KW)
    try:
        with exp._lock:
            exp._ensure_ring()
        ring = exp.ring
        calls = {"n": 0, "trips": [], "spin_at": None}
        wait = ring._wait_slot

        def counted(trace=None):
            i = calls["n"]
            calls["n"] += 1
            t1 = time.perf_counter()
            try:
                return wait(trace) if trace is not None else wait()
            except staging.StagingWedged:
                calls["trips"].append((i, time.perf_counter() - t1))
                raise
        ring._wait_slot = counted
        fold_spans = []
        fold = exp._fold_events

        def timed_fold(events, feats):
            e0 = exp.ingest_errors
            t1 = time.perf_counter()
            fold(events, feats)
            fold_spans.append((time.perf_counter() - t1,
                               exp.ingest_errors > e0))
        exp._fold_events = timed_fold
        resets0 = ring.dict_resets
        errs0 = metrics.sketch_ingest_errors_total._value.get()
        g = _stream_evictions(n_rows)
        fed = []
        for _ in range(4):
            fed.append(next(g))
            exp.export_evicted(eviction(ints, *fed[-1]))
        torch.cuda.synchronize()
        calls["spin_at"] = calls["n"]
        t_spin = time.perf_counter()
        torch.cuda._sleep(cycles)
        spun = torch.cuda.Event()
        spun.record()
        while not spun.query():  # fold on until the spin has run
            fed.append(next(g))
            exp.export_evicted(eviction(ints, *fed[-1]))
            check(len(fed) < 100, "the wedge never cleared")
        spin_s = time.perf_counter() - t_spin
        spin_done = calls["n"]
        for _ in range(4):
            fed.append(next(g))
            exp.export_evicted(eviction(ints, *fed[-1]))
        timed = settled(exp)
        torch.cuda.synchronize()  # no CUDA error after the wedge
        trips = calls["trips"]
        errs = metrics.sketch_ingest_errors_total._value.get() - errs0
        tripped = [dt for dt, t in fold_spans if t]
        check(trips and errs == len(trips) == exp.ingest_errors
              == len(tripped),
              f"{len(trips)} trips, {errs} counted, {exp.ingest_errors} "
              f"ingest errors, {len(tripped)} tripped folds")
        check(max(tripped) <= OV_BUDGET_S + 0.2,
              f"a tripped fold took {max(tripped):.3f} s")
        check(ring.dict_resets == resets0, "the wedge rolled an epoch")
        first = trips[0][0] - calls["spin_at"]
        check(0 <= first <= len(ring._bufs),
              f"the first trip came {first} slot waits after the spin "
              f"({len(ring._bufs)} slots)")
        check(trips[-1][0] < spin_done and calls["n"] > trips[-1][0] + 1,
              "the feed did not fold on after the spin")
        trip_at = {i for i, _ in trips}
        # the replay: the plain versions, eager, the same folds dropped by
        # a never-ready copy event at the same slot waits
        with plain_versions(specs):
            rep = TorchSketchExporter(cfg, batch_size=BATCH, device="cuda",
                                      sink=_discard, capture=False,
                                      shed_watermark=1e9, **LANES_KW)
            try:
                with rep._lock:
                    rep._ensure_ring()
                rring = rep.ring
                rwait = rring._wait_slot
                rcalls = [0]

                def replay_wait(trace=None):
                    i = rcalls[0]
                    rcalls[0] += 1
                    args = () if trace is None else (trace,)
                    if i not in trip_at:
                        return rwait(*args)
                    slot = rring._slot
                    real_ev = rring._copied[slot]
                    rring._copied[slot] = NeverReady()
                    rring.slot_wait_budget_s = 0.001
                    try:
                        return rwait(*args)
                    finally:
                        rring._copied[slot] = real_ev
                        rring.slot_wait_budget_s = 30.0
                rring._wait_slot = replay_wait
                for lo, hi in fed:
                    rep.export_evicted(eviction(ints, lo, hi))
                replayed = settled(rep)
                check(rcalls[0] == calls["n"]
                      and rep.ingest_errors == exp.ingest_errors,
                      f"replay slot waits {rcalls[0]} / {calls['n']}, "
                      f"errors {rep.ingest_errors}")
            finally:
                rep.close()
        check(same(timed, replayed),
              "the wedged run's tables differ from the plain replay's")
        out["wedge"] = {
            "budget_s": OV_BUDGET_S, "spin_s": OV_SPIN_S,
            "spin_seen_s": spin_s,
            "spin_cycles": cycles, "slots": len(ring._bufs),
            "trips": len(trips),
            "first_trip_wait_s": trips[0][1],
            "first_trip_slot_waits_after_spin": first,
            "tripped_fold_s_max": max(tripped),
            "evictions": len(fed), "slot_waits": calls["n"],
            "replay_equal": True}
    finally:
        exp.close()
    check(retrace.total_retraces() == retraces0, "a retrace in the phase")
    out["seconds"] = time.perf_counter() - t_phase
    return out


#: the agent_entry phase: seconds of the production stream's feed and of
#: the integer-mass copy's, the in-process agent's CACHE_ACTIVE_TIMEOUT,
#: the evictions the feeder keeps ahead of the exporter at most (the
#: fetcher's, the evicted and the export queues together: the limiter
#: drops nothing), and the child agent's eviction period over the pcap
AE_SECONDS = 3.0
AE_INT_SECONDS = 1.5
#: the integer-mass copy's feed rate (records/s): at most about 1 M records
#: a 1 s window keeps every per-cell f32 sum below 2^24 (the hottest key,
#: about a fifth of the Zipf 1.2 stream at 32 bytes a row on average, puts
#: some 6.4 bytes a record into its cells), where add order cannot change
#: a bit; the unthrottled feed passes 2.6 M records a window and breaks it
AE_INT_RATE = 800_000
AE_TICK = "2ms"
AE_BACKLOG = 2
AE_CHILD_TICK = "200ms"
#: the eviction families the child's /metrics must carry
AE_FAMILIES = ("ebpf_agent_evictions_total", "ebpf_agent_evicted_flows_total",
               "ebpf_agent_evicted_flows_per_drain",
               "ebpf_agent_lookup_and_delete_map_duration_seconds",
               "ebpf_agent_map_occupancy_ratio",
               "ebpf_agent_exported_flows_total")


def _lanes_rate(lanes_res: dict) -> float:
    """The lanes path's steady records/s: its last window's."""
    return lanes_res["records_per_s"][-1]


def _agent_env(**extra) -> dict:
    return {"EXPORT": "tpu-sketch", "SKETCH_BATCH_SIZE": str(BATCH),
            "SKETCH_WINDOW": "1s", "CACHE_ACTIVE_TIMEOUT": AE_TICK,
            "AGENT_IP": "127.0.0.1", **extra}


def _pcts(xs) -> dict:
    import numpy as np
    if not xs:
        return {}
    a = np.asarray(xs)
    return {"p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)), "max": float(a.max())}


def _agent_run(stream, seconds: float, specs,
               max_rate: float | None = None) -> dict:
    """One in-process agent of the port (module docstring, `agent_entry`
    (a)) fed `stream`'s evictions for `seconds`, at most `max_rate`
    records/s when given, then stopped; its reports, roll seam, evictions
    fed and timings."""
    import threading
    import numpy as np
    import torch
    from netobserv_tpu_torch.agent import FlowsAgent, Status
    from netobserv_tpu_torch.config import load_config
    from netobserv_tpu_torch.datapath.fetcher import EvictedFlows, FakeFetcher
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    from netobserv_tpu_torch.metrics.registry import Metrics, MetricsSettings
    from netobserv_tpu_torch.utils import retrace, tracing
    ev_all, lanes_all = stream
    cfg = load_config(_agent_env())
    cfg.validate()
    metrics = Metrics(MetricsSettings())
    sink = WindowSink()
    tracing.configure(sample=1.0, capacity=1 << 14)
    retraces0 = retrace.total_retraces()
    exp = TorchSketchExporter.from_config(cfg, metrics=metrics, sink=sink)
    fake = FakeFetcher()
    agent = FlowsAgent(cfg, fake, exp, metrics=metrics)
    marks: dict = {}  # id(eviction) -> [evicted put, export put, start, end]

    def timed_put(q, slot):
        put = q.put_nowait

        def put_nowait(item):
            marks.setdefault(id(item), [None] * 4)[slot] = \
                time.perf_counter()
            return put(item)
        q.put_nowait = put_nowait

    timed_put(agent._evicted_q, 0)
    timed_put(agent._export_q, 1)
    export = agent.terminal._export

    def timed_export(batch):
        m = marks[id(batch)]
        m[2] = time.perf_counter()
        export(batch)
        m[3] = time.perf_counter()
    agent.terminal._export = timed_export
    objs, fed = [], []
    gen = _stream_evictions(len(ev_all))

    def backlog() -> int:
        return (fake._evictions.qsize() + agent._evicted_q.qsize()
                + agent._export_q.qsize())

    def feeder():
        t0 = time.perf_counter()
        rows = 0
        while time.perf_counter() < t0 + seconds:
            if backlog() >= AE_BACKLOG or (
                    max_rate is not None
                    and rows > max_rate * (time.perf_counter() - t0)):
                time.sleep(0.0002)
                continue
            lo, hi = next(gen)
            rows += hi - lo
            ev = EvictedFlows(ev_all[lo:hi],
                              **{k: v[lo:hi] for k, v in lanes_all.items()})
            objs.append(ev)
            fed.append((lo, hi))
            fake.inject_eviction(ev)

    try:
        with exp._lock:
            exp._ensure_ring()  # the ladder's captures, before the clock
            ring = exp.ring
            seam = RollSeam(exp)
        captures0 = [c.captures for c in exp.captures]
        for s in specs:
            s["kernel"].launches = 0
        stop = threading.Event()
        runner = threading.Thread(target=agent.run, args=(stop,),
                                  daemon=True)
        runner.start()
        deadline = time.monotonic() + 10
        while agent.status != Status.STARTED and time.monotonic() < deadline:
            time.sleep(0.001)
        check(agent.status == Status.STARTED, "the agent did not start")
        with exp._lock:  # the first window starts with the feed
            exp._deadline = time.monotonic() + exp.window_s
        feed = threading.Thread(target=feeder, daemon=True)
        feed.start()
        feed.join()
        rows_fed = sum(hi - lo for lo, hi in fed)

        def exported() -> float:
            return metrics.exported_flows_total.labels(
                exp.name)._value.get()
        deadline = time.monotonic() + 30
        while exported() < rows_fed and time.monotonic() < deadline:
            time.sleep(0.001)
        torch.cuda.synchronize()
        captures1 = [c.captures for c in exp.captures]  # close drops them
        t_stop = time.perf_counter()
        stop.set()
        runner.join(timeout=30)
        stop_s = time.perf_counter() - t_stop
        check(not runner.is_alive() and agent.status == Status.STOPPED,
              f"the agent did not stop ({agent.status})")
    finally:
        tracing.configure(sample=0.0)
    launches = {s["name"]: s["kernel"].launches for s in specs}
    traces = [t for t in tracing.snapshot() if t["kind"] == "batch"]
    dropped = sum(m.value for fam in metrics.dropped_flows_total.collect()
                  for m in fam.samples if m.name.endswith("_total"))
    reps = sink.reports
    check(len(marks) == len(fed) and all(None not in m
                                         for m in marks.values()),
          f"{len(marks)} evictions marked of {len(fed)} fed")
    check(dropped == 0, f"{dropped} rows dropped")
    check([r["Window"] for r in reps] == list(range(exp.rolls))
          and exp.reports_published == exp.rolls
          and exp.reports_shed == 0, f"windows {[r['Window'] for r in reps]}")
    check(sum(r["Records"] for r in reps) == float(rows_fed)
          and exp.records == rows_fed and exp.ingest_errors == 0,
          f"records {sum(r['Records'] for r in reps)}, fed {rows_fed}")
    check(captures1 == captures0 and retrace.total_retraces() == retraces0,
          f"captures {captures1} (was {captures0}), retraces "
          f"{retrace.total_retraces() - retraces0}")
    want = _want_launches(specs, "lanes", exp.folds)
    check(launches == want and all(
        launches[n] > 0 for n, v in want.items() if v),
        f"launches {launches}, want {want}")
    t_first = min(m[0] for m in marks.values())
    t_last = sink.spans[-1][1]
    ms = [[(b - a) * 1e3 for a, b in zip(m, m[1:])] for m in marks.values()]
    return {"exp": exp, "ring": ring, "seam": seam, "fed": fed,
            "reports": reps, "launches": launches,
            "records_fed": rows_fed, "evictions": len(fed),
            "windows": exp.rolls, "folds": exp.folds,
            "lanes": ring.lanes, "feed_seconds": seconds,
            "records_per_s": rows_fed / (t_last - t_first),
            "records_per_s_to_last_export": rows_fed / (
                max(m[3] for m in marks.values()) - t_first),
            "stop_seconds": stop_s,
            "evict_ms": _pcts([st["dur_ms"] for t in traces
                               for st in t["stages"]
                               if st["stage"] == "evict"]),
            "limiter_ms": _pcts([m[0] for m in ms]),
            "export_wait_ms": _pcts([m[1] for m in ms]),
            "export_ms": _pcts([m[2] for m in ms]),
            "export_ms_per_16384": float(np.sum([m[2] for m in ms]))
            * BATCH / rows_fed,
            "dropped": dropped}


def _replay_agent_run(run: dict, stream, specs, plain: bool):
    """An exporter of the agent's settings fed the same evictions in the
    same order, rolled after the same ones (the agent's last window
    closed by `close`): eager with the plain versions and their per-cell
    add counts (`plain`), or captured with the kernels. Its roll seam."""
    from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    exp, ev_all, lanes_all = run["exp"], *stream
    adds, touched = ({}, {}) if plain else (None, None)
    ctx = (plain_versions(specs, adds, touched) if plain
           else contextlib.nullcontext())
    with ctx:
        exp2 = TorchSketchExporter(
            exp.cfg, batch_size=exp.batch_size, device="cuda",
            capture=not plain, sink=_discard, pack_threads=exp.pack_threads,
            superbatch=exp.superbatch, resident_slots=exp.resident_slots)
        with exp2._lock:
            exp2._ensure_ring()
        seam2 = RollSeam(exp2, adds, touched, keep_state=True)
        at = [a for a, _, _ in run["seam"].rolls]
        j = 0
        for i, (lo, hi) in enumerate(run["fed"]):
            while j < len(at) - 1 and at[j] == i:
                exp2.roll()
                j += 1
            exp2.export_evicted(EvictedFlows(
                ev_all[lo:hi], **{k: v[lo:hi] for k, v in lanes_all.items()}))
        while j < len(at) - 1:
            exp2.roll()
            j += 1
        exp2.close()
    check(len(seam2.rolls) == len(at), f"{len(seam2.rolls)} replayed rolls, "
          f"{len(at)} of the agent")
    return seam2


def _read_reports(path) -> list:
    with open(path) as fh:
        return [json.loads(x) for x in fh if x.strip()]


def _metric(text: str, name: str, label: str = "") -> float:
    import re
    m = re.search(rf"^{name}{re.escape(label)} (\S+)$", text, re.M)
    return float(m.group(1)) if m else 0.0


def _agent_child(root: str, env: dict, out_dir: str, name: str):
    """`python3 -m netobserv_tpu_torch` from `root` with `env` over a clean
    environment (no SKETCH_*, DATAPATH or EXPORT of this one), its
    standard output and error into files of `out_dir`."""
    import os
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("SKETCH_", "DATAPATH", "EXPORT",
                                 "METRICS_", "FAULT_POINTS", "TRACE_"))}
    base.update(PYTHONPATH=root, AGENT_IP="127.0.0.1", **env)
    out = open(os.path.join(out_dir, f"{name}.out"), "wb")
    err = open(os.path.join(out_dir, f"{name}.err"), "wb")
    proc = subprocess.Popen([sys.executable, "-m", "netobserv_tpu_torch"],
                            cwd=root, env=base, stdout=out, stderr=err)
    return proc, out, err


def _wait_started(proc, base: str, timeout: float = 90.0) -> float:
    """Seconds until the child's /healthz answers 200 with status
    Started."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        check(proc.poll() is None, f"the child exited {proc.returncode} "
              "before it started")
        try:
            code, body = _http_json(base + "/healthz")
            if code == 200 and body.get("status") == "Started":
                return time.perf_counter() - t0
        except OSError:
            pass
        time.sleep(0.05)
    raise PhaseError("the child never answered /healthz Started")


def _sigterm(proc, timeout: float = 15.0) -> float:
    import signal
    import subprocess
    t0 = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise PhaseError(f"the child outlived SIGTERM by {timeout} s")
    return time.perf_counter() - t0


def _scenario_pcap(path: str):
    """A SYN flood (300 spoofed sources, victim 10.0.0.80, never
    answered), a port scan (one source, 600 ports) and an elephant (50
    packets claiming 60,000 bytes each) over 2 s of capture, built with
    the port's `scenarios/synth.py` as tests/test_e2e_replay.py and
    tests/test_scenarios.py build theirs."""
    from netobserv_tpu_torch.scenarios import synth
    b = synth.PcapBuilder()
    for i in range(300):
        b.add(i * 1000, f"172.16.{i % 250}.{i // 250 + 1}", "10.0.0.80", 6,
              synth.tcp(1024 + i, 80, 0x02), sport=1024 + i, dport=80)
    for p in range(600):
        b.add(400_000 + p * 1000, "192.0.2.7", "10.0.0.9", 6,
              synth.tcp(40000, 1 + p, 0x02), sport=40000, dport=1 + p)
    for i in range(50):
        b.add(1_000_000 + i * 20_000, "10.0.0.1", "10.0.0.2", 6,
              synth.tcp(5001, 443, 0x18), claim_len=60_000, sport=5001,
              dport=443)
    b.write(path)
    return b


def _agent_children(root: str, out_dir: str) -> dict:
    """`agent_entry` (b): the pcap child, the synthetic child and the one
    with no DATAPATH (module docstring)."""
    import os
    import socket
    import urllib.request
    from netobserv_tpu_torch.config import parse_duration
    from netobserv_tpu_torch.datapath.replay import PcapReplayFetcher
    pcap = os.path.join(out_dir, "scenario.pcap")
    _scenario_pcap(pcap)
    replay = PcapReplayFetcher(pcap, window_s=parse_duration(AE_CHILD_TICK))
    want_rows = sum(len(w[0]) for w in replay._windows)
    want_bytes = sum(float(w[0]["stats"]["bytes"].sum())
                     for w in replay._windows)

    def free_port() -> int:
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            return sk.getsockname()[1]

    out = {"pcap_rows": want_rows, "pcap_bytes": want_bytes,
           "pcap_evictions": replay.n_windows}
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    proc, fo, fe = _agent_child(root, {
        "DATAPATH": f"pcap:{pcap}", "EXPORT": "tpu-sketch",
        "METRICS_ENABLE": "true", "METRICS_SERVER_ADDRESS": "127.0.0.1",
        "METRICS_SERVER_PORT": str(port), "SKETCH_WINDOW": "1s",
        "CACHE_ACTIVE_TIMEOUT": AE_CHILD_TICK}, out_dir, "pcap")
    try:
        out["pcap_start_to_started_s"] = _wait_started(proc, base)
        for route in ("/healthz", "/readyz"):
            code, body = _http_json(base + route)
            check(code == 200 and body["status"] == "Started",
                  f"{route}: {code} {body.get('status')}")
        deadline = time.monotonic() + 60
        text = ""
        while time.monotonic() < deadline:
            with urllib.request.urlopen(base + "/metrics", timeout=5) as r:
                text = r.read().decode()
            if _metric(text, "ebpf_agent_exported_flows_total",
                       '{exporter="tpu-sketch"}') >= want_rows:
                break
            time.sleep(0.02)
        check(_metric(text, "ebpf_agent_exported_flows_total",
                      '{exporter="tpu-sketch"}') == want_rows,
              "the child did not export every row of the pcap")
        missing = [f for f in AE_FAMILIES if f not in text]
        check(not missing, f"/metrics lacks {missing}")
        code, status = _http_json(base + "/query/status")
        check(code == 200, f"/query/status {code}")
        fo.flush()
        before = len(_read_reports(fo.name))
        out["pcap_sigterm_to_exit_s"] = _sigterm(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        fo.close()
        fe.close()
    err = open(fe.name, "rb").read()
    check(proc.returncode == 0, f"the pcap child exited {proc.returncode}: "
          f"{err[-2000:]!r}")
    reps = _read_reports(fo.name)
    check([r["Window"] for r in reps] == list(range(len(reps))),
          f"windows {[r['Window'] for r in reps]}")
    check(len(reps) > before, "SIGTERM published no last window")
    check(sum(r["Records"] for r in reps) == float(want_rows)
          and sum(r["Bytes"] for r in reps) == want_bytes,
          f"records {sum(r['Records'] for r in reps)} of {want_rows}, "
          f"bytes {sum(r['Bytes'] for r in reps)} of {want_bytes}")
    floods = [b for r in reps for b in r["SynFloodSuspectBuckets"]]
    check(any("10.0.0.80" in b["probable_victims"] for b in floods),
          f"the flood's victim not named: {floods}")
    out.update(pcap_windows=len(reps), pcap_last_window_records=reps[-1][
        "Records"], pcap_reports_after_sigterm=len(reps) - before,
        syn_flood=next(b for b in floods
                       if "10.0.0.80" in b["probable_victims"]),
        port_scan_buckets=sum(
            len(r["PortScanSuspectBuckets"]) for r in reps),
        query_status_windows=status.get("window"))

    port = free_port()
    base = f"http://127.0.0.1:{port}"
    proc, fo, fe = _agent_child(root, {
        "DATAPATH": "synthetic", "EXPORT": "tpu-sketch",
        "METRICS_ENABLE": "true", "METRICS_SERVER_ADDRESS": "127.0.0.1",
        "METRICS_SERVER_PORT": str(port), "SKETCH_WINDOW": "1s"},
        out_dir, "synthetic")
    try:
        out["synthetic_start_to_started_s"] = _wait_started(proc, base)
        out["synthetic_sigterm_to_exit_s"] = _sigterm(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        fo.close()
        fe.close()
    check(proc.returncode == 0, f"the synthetic child exited "
          f"{proc.returncode}")

    out.update(_ladder_children(root, out_dir, free_port()))
    return out


#: what the no-DATAPATH child's log must show, by the rung it reaches
#: (`agent.build_fetcher`, `datapath/loader._load_clang_or_fallback`)
AE_CLANG_LINE = "no clang-built BPF object ("
AE_MINIMAL_LINE = "assembler datapath features:"
AE_FALLBACK_LINE = "kernel datapath unavailable ("


def _expected_rung() -> tuple[str, str]:
    """The rung this machine allows a child with no clang object, and the
    minimal rung's error text where it fails: "minimal" where the child is
    root and bpf(2) and a writable bpffs answer (`_kd_probe_bpf`; the
    default TC_ATTACH_MODE=tcx needs no tc binary), else "synthetic"."""
    import errno
    import os
    if os.geteuid() != 0:
        return "synthetic", "kernel datapath requires root/CAP_BPF"
    why = _kd_probe_bpf()
    if why is None:
        return "minimal", ""
    if why.startswith("bpf(2): "):
        code = getattr(errno, why[len("bpf(2): "):], None)
        return "synthetic", os.strerror(code) if code else ""
    return "synthetic", ""


def _ladder_children(root: str, out_dir: str, port: int) -> dict:
    """`agent_entry` (b)'s last two children: no DATAPATH, and
    DATAPATH=kernel (module docstring)."""
    import os
    import urllib.request
    rung, error = _expected_rung()
    out = {"ladder_rung_expected": rung, "ladder_minimal_error": error,
           "bpf_probe": _kd_probe_bpf()}
    base = f"http://127.0.0.1:{port}"
    # INTERFACES=lo and no EXCLUDE_INTERFACES (whose default is lo): a
    # kernel rung may attach to lo and nothing else; LISTEN_INTERFACES=poll
    # lists this namespace's links only, where the default watch would
    # enter every namespace under /var/run/netns
    proc, fo, fe = _agent_child(root, {
        "EXPORT": "tpu-sketch", "INTERFACES": "lo", "EXCLUDE_INTERFACES": "",
        "LISTEN_INTERFACES": "poll", "METRICS_ENABLE": "true",
        "METRICS_SERVER_ADDRESS": "127.0.0.1",
        "METRICS_SERVER_PORT": str(port)}, out_dir, "no_datapath")
    try:
        out["no_datapath_start_to_started_s"] = _wait_started(proc, base)
        code, body = _http_json(base + "/healthz")
        check(code == 200 and body["status"] == "Started",
              f"/healthz: {code} {body.get('status')}")
        deadline = time.monotonic() + 30
        text = ""
        while time.monotonic() < deadline:
            with urllib.request.urlopen(base + "/metrics", timeout=5) as r:
                text = r.read().decode()
            if _metric(text, "ebpf_agent_exported_flows_total",
                       '{exporter="tpu-sketch"}') > 0:
                break
            time.sleep(0.05)
        out["no_datapath_exported_before_sigterm"] = _metric(
            text, "ebpf_agent_exported_flows_total",
            '{exporter="tpu-sketch"}')
        out["no_datapath_sigterm_to_exit_s"] = _sigterm(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        fo.close()
        fe.close()
    err = open(fe.name, "rb").read().decode(errors="replace")
    check(proc.returncode == 0, f"no DATAPATH: exit {proc.returncode}, "
          f"{err[-1500:]!r}")
    reps = _read_reports(fo.name)
    records = sum(r["Records"] for r in reps)
    check(records > 0, f"no DATAPATH: {len(reps)} reports, {records} "
          "records")
    at = {line: err.find(line) for line in (
        AE_CLANG_LINE, AE_MINIMAL_LINE, AE_FALLBACK_LINE)}
    if os.geteuid() == 0:
        check(at[AE_CLANG_LINE] >= 0, "no DATAPATH: the clang-object line "
              f"is missing: {err[-1500:]!r}")
    import re
    # `interfaces_listener`'s line: attached to NAME (index N, netns 'NS')
    attached = re.findall(
        r"attached to (\S+) \(index \d+, netns '([^']*)'\)", err)
    check(set(attached) <= {("lo", "")},
          f"no DATAPATH: attached to {attached}")
    out["no_datapath_attached"] = [name for name, _ns in attached]
    if rung == "minimal":
        # the first rung's own fallback provisions the assembler datapath
        check(at[AE_MINIMAL_LINE] > at[AE_CLANG_LINE]
              and at[AE_FALLBACK_LINE] < 0,
              f"no DATAPATH: the minimal rung not reached: {err[-1500:]!r}")
        reached = "minimal"
    else:
        warn = err[at[AE_FALLBACK_LINE]:].split("\n", 1)[0]
        check(at[AE_FALLBACK_LINE] > at[AE_CLANG_LINE] and error in warn,
              f"no DATAPATH: the fallback warning with {error!r} missing: "
              f"{err[-1500:]!r}")
        out["no_datapath_fallback_warning"] = warn
        reached = "synthetic"
    out.update(no_datapath_rung=reached, no_datapath_reports=len(reps),
               no_datapath_records=records)
    print(f"agent_entry: no DATAPATH reached the {reached} rung, Started in "
          f"{out['no_datapath_start_to_started_s']:.2f} s, {records:.0f} "
          "records", flush=True)

    if rung == "minimal":
        # the kernel rung loads here, so a DATAPATH=kernel child would run
        # the same agent as the one above
        out["kernel_child"] = "not run: the minimal rung loads on this host"
        return out
    proc, fo, fe = _agent_child(root, {
        "EXPORT": "tpu-sketch", "DATAPATH": "kernel", "INTERFACES": "lo",
        "EXCLUDE_INTERFACES": "", "LISTEN_INTERFACES": "poll"}, out_dir,
        "kernel")
    t0 = time.perf_counter()
    try:
        proc.wait(timeout=90)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        fo.close()
        fe.close()
    err = open(fe.name, "rb").read().decode(errors="replace")
    check(proc.returncode not in (0, None) and (error or "kernel") in err,
          f"DATAPATH=kernel: exit {proc.returncode}, {err[-1500:]!r}")
    out.update(kernel_exit=proc.returncode,
               kernel_start_to_exit_s=time.perf_counter() - t0,
               kernel_error=err.strip().splitlines()[-1][-300:])
    print(f"agent_entry: DATAPATH=kernel exited {proc.returncode} after "
          f"{out['kernel_start_to_exit_s']:.2f} s: {out['kernel_error']}",
          flush=True)
    return out


def phase_agent_entry(specs, events, lanes_rate: float, wt_rate: float,
                      card: str) -> dict:
    """The port's agent entry on the card (module docstring,
    `agent_entry`)."""
    import os
    import tempfile
    import numpy as np
    from netobserv_tpu_torch.sketch import state as sk
    t_phase = time.perf_counter()
    stream = LaneFeeder(events).stream
    run = _agent_run(stream, AE_SECONDS, specs)
    check(run["windows"] >= 2, f"{run['windows']} windows")
    kt = key_table_check(run["ring"])
    seam2 = _replay_agent_run(run, stream, specs, plain=True)
    cmp = []
    for w, (reps, rep2) in enumerate(zip(run["seam"].rolls, seam2.rolls)):
        tables = sk.state_tables(reps[1])
        tables2 = sk.state_tables(rep2[1])
        cmp.append(compare_tables(tables, tables2, rep2[2]))
    ints = _integer_stream(events)
    irun = _agent_run(ints, AE_INT_SECONDS, specs, max_rate=AE_INT_RATE)
    iseam = _replay_agent_run(irun, ints, specs, plain=False)
    for w, (a, b) in enumerate(zip(irun["seam"].rolls, iseam.rolls)):
        ta, tb = sk.state_tables(a[1]), sk.state_tables(b[1])
        diff = [k for k in ta if not np.array_equal(ta[k], tb[k])]
        check(not diff, f"integer window {w}: tables {diff} differ")
    with tempfile.TemporaryDirectory() as tmp:
        children = _agent_children(
            os.path.dirname(os.path.abspath(__file__)), tmp)
    print("agent_entry: start to Started s: " + ", ".join(
        f"{k[:-len('_start_to_started_s')]} "
        f"{children[k]:.2f}" for k in children
        if k.endswith("_start_to_started_s")), flush=True)
    drop = ("exp", "ring", "seam", "fed", "reports", "launches")
    return {"phase": "agent_entry", "card": card,
            "in_process": {k: v for k, v in run.items() if k not in drop},
            "lanes_path_records_per_s": lanes_rate,
            "window_thread_records_per_s": wt_rate,
            "agent_over_lanes": run["records_per_s"] / lanes_rate,
            "launches": run["launches"], "key_table": kt,
            "vs_plain_replay": cmp,
            "integer_windows_exact": irun["windows"],
            "integer_records_fed": irun["records_fed"],
            "integer_records_per_window": [r["Records"]
                                           for r in irun["reports"]],
            "children": children,
            "seconds": time.perf_counter() - t_phase}


#: the ifaces_features phase: the feature run's map rows, ring-buffer
#: singles over IF_RB_FLOWS flows, SSL writes over IF_PIDS processes, its
#: seed and its budget
IF_MAP_ROWS = 8192
IF_RB_EVENTS = 4096
IF_RB_FLOWS = 512
IF_SSL_EVENTS = 256
IF_PIDS = 64
IF_SEED = 23
IF_BUDGET_S = 60.0
#: the UDN mapping file's names, by interface name (the default namer
#: names an interface by its index)
IF_UDNS = {"1": "udn-blue", "2": "udn-red"}


class _RecordingFetcher:
    """(b)'s fetcher: asks for discovery and records attach and detach."""

    needs_iface_discovery = True

    def __init__(self):
        self.calls: list = []

    def attach(self, if_index, if_name, direction, netns=""):
        self.calls.append(("attach", if_index, if_name, direction, netns))

    def detach(self, if_index, if_name, netns=""):
        self.calls.append(("detach", if_index, if_name, netns))


class _ScriptedInformer:
    """(b)'s informer where the netlink socket is refused: the up
    interfaces of IF_SCRIPTED_LINKS, as a `Poller`'s first dump reports
    them."""

    def __init__(self, links):
        import queue
        from netobserv_tpu_torch import ifaces
        self.events = queue.Queue()
        for idx, name, mac in links:
            self.events.put(ifaces.Event(ifaces.EventType.ADDED,
                                         ifaces.Interface(idx, name, mac)))

    def subscribe(self):
        return self.events

    def stop(self):
        pass


#: (b)'s interfaces where the netlink socket is refused
IF_SCRIPTED_LINKS = [(1, "lo", bytes(6), True),
                     (2, "eth0", b"\x02" * 6, True),
                     (3, "eth1", b"\x03" * 6, True),
                     (4, "eth2", b"\x04" * 6, False)]


def _link_witness() -> tuple[str, dict] | None:
    """(a)'s witness: (its source, name -> index) of this namespace's
    interfaces as listed without the port's netlink code, from
    /sys/class/net, else /proc/net/dev's names through if_nametoindex(3),
    else libc's if_nameindex(3); None where none of them lists any."""
    import os
    import socket
    if os.path.isdir("/sys/class/net"):
        got = {}
        for name in os.listdir("/sys/class/net"):
            with open(f"/sys/class/net/{name}/ifindex") as fh:
                got[name] = int(fh.read())
        if got:
            return "/sys/class/net", got
    try:
        with open("/proc/net/dev") as fh:
            names = [ln.split(":", 1)[0].strip()
                     for ln in fh.readlines()[2:] if ":" in ln]
        got = {n: socket.if_nametoindex(n) for n in names}
        if got:
            return "/proc/net/dev", got
    except OSError:
        pass
    try:
        got = {n: i for i, n in socket.if_nameindex()}
    except OSError:
        return None
    return ("if_nameindex", got) if got else None


def _if_listener(links: list, source: str) -> dict:
    """(b): an `InterfaceListener` over a `Poller` where `links` (index,
    name, mac, up) came from netlink, else over IF_SCRIPTED_LINKS, with a
    recording fetcher and an INTERFACES/EXCLUDE_INTERFACES pair."""
    from netobserv_tpu_torch import ifaces
    from netobserv_tpu_torch.agent.interfaces_listener import (
        InterfaceListener,
    )
    from netobserv_tpu_torch.config import load_config
    from netobserv_tpu_torch.metrics.registry import Metrics, MetricsSettings
    from netobserv_tpu_torch.model import record
    up = [(i, n, m) for i, n, m, u in links if u]
    others = [n for _i, n, _m in up if n != "lo"]
    # lo, and one more where that leaves an interface to attach
    excluded = ["lo"] + others[:len(others) > 1]
    cfg = load_config({"EXPORT": "tpu-sketch", "INTERFACES": "/./",
                       "EXCLUDE_INTERFACES": ",".join(excluded)})
    want = sorted((i, n) for i, n, _m in up if n not in excluded)
    metrics = Metrics(MetricsSettings())
    fetcher = _RecordingFetcher()
    informer = (ifaces.Poller(period_s=60) if source == "netlink"
                else _ScriptedInformer(up))
    listener = InterfaceListener(cfg, fetcher, metrics=metrics,
                                 informer=informer)
    listener.start()
    try:
        check(record.interface_namer() == listener._registerer.name_for,
              "the listener did not install its namer")
        deadline = time.monotonic() + 10
        while (len(fetcher.calls) < len(want)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        time.sleep(0.3)  # anything more would be an attach too many
    finally:
        listener.stop()
    check(record.interface_namer() is record.default_namer,
          "stop did not restore the default namer")
    got = sorted((c[1], c[2]) for c in fetcher.calls)
    check(got == want and all(c[0] == "attach" and c[3] == cfg.direction
                              for c in fetcher.calls),
          f"attached {fetcher.calls}, want {want}")
    counted = {}
    for fam in metrics.interface_events_total.collect():
        for smp in fam.samples:
            if smp.name.endswith("_total"):
                kind = smp.labels["type"]
                counted[kind] = counted.get(kind, 0) + smp.value
    expect = {k: float(v) for k, v in (("added", len(up)),
                                       ("attach", len(want))) if v}
    check(counted == expect,
          f"interface_events_total {counted}, up {len(up)}, want "
          f"{len(want)}")
    return {"informer": type(informer).__name__, "links_from": source,
            "up": len(up),
            "excluded": excluded, "attached": [n for _i, n in got],
            "interface_events_total": counted}


def _if_feed(rng):
    """(c)'s feed: one map eviction of IF_MAP_ROWS distinct flows,
    IF_RB_EVENTS ring-buffer singles over IF_RB_FLOWS others, and
    IF_SSL_EVENTS SSL writes by IF_PIDS processes, each owning the
    sockets of a few of the map's flows (the resolver of the correlator);
    integer bytes on three interfaces."""
    import numpy as np
    from netobserv_tpu_torch.model import binfmt

    def flows(n, first_octet):
        ev = np.zeros(n, binfmt.FLOW_EVENT_DTYPE)
        k = ev["key"]
        for side, octet in (("src_ip", first_octet), ("dst_ip", 172)):
            k[side][:, 10:12] = 0xFF
            k[side][:, 12] = octet
            k[side][:, 13:] = rng.integers(0, 256, (n, 3))
        k["src_port"] = rng.integers(1024, 65536, n)
        k["dst_port"] = rng.choice([443, 8443], n)
        k["proto"] = 6
        st = ev["stats"]
        # small packets: the whole feed stays below 2^24 bytes, so every
        # per-cell f32 sum is an integer added exactly in any order
        st["packets"] = rng.integers(1, 9, n)
        st["bytes"] = st["packets"] * rng.integers(40, 80, n)
        st["eth_protocol"] = 0x0800
        st["if_index_first"] = rng.integers(1, 4, n)
        st["first_seen_ns"] = 10**12 + np.arange(n)
        st["last_seen_ns"] = st["first_seen_ns"] + 1000
        return ev

    agg = flows(IF_MAP_ROWS, 10)
    _, first = np.unique(np.array([k.tobytes() for k in agg["key"]]),
                         return_index=True)
    agg = agg[np.sort(first)]
    rb_keys = flows(IF_RB_FLOWS, 11)
    singles = rb_keys[rng.integers(0, len(rb_keys), IF_RB_EVENTS)]
    singles["stats"]["packets"] = 1
    singles["stats"]["bytes"] = rng.integers(40, 80, IF_RB_EVENTS)
    owned = {}
    for pid in range(1, IF_PIDS + 1):
        rows = rng.integers(0, len(agg), int(rng.integers(0, 4)))
        owned[pid] = [(bytes(agg[r]["key"]["src_ip"]),
                       int(agg[r]["key"]["src_port"]),
                       bytes(agg[r]["key"]["dst_ip"]),
                       int(agg[r]["key"]["dst_port"])) for r in rows]
    ssl = []
    for _ in range(IF_SSL_EVENTS):
        ev = np.zeros(1, binfmt.SSL_EVENT_DTYPE)
        n = int(rng.integers(1, 200))
        pid = int(rng.integers(1, IF_PIDS + 1))
        ev["pid_tgid"] = (pid << 32) | pid
        ev["data_len"] = n
        ev["ssl_type"] = 1
        ev[0]["data"][:n] = rng.integers(0, 256, n, dtype=np.uint8)
        ssl.append(ev.tobytes())
    return agg, singles, ssl, owned


class _RecordPath:
    """The sketch exporter taken on its record path (`export_batch`), as
    the reference's agent takes a record exporter: on its columnar path
    no record is made, so the agent builds no correlator there (it only
    warns). Keeps each batch it hands on."""

    supports_columnar = False

    def __init__(self, exp):
        self.exp = exp
        self.name = exp.name
        self.batches: list = []

    def export_batch(self, records) -> None:
        self.batches.append(records)
        self.exp.export_batch(records)

    def close(self) -> None:
        self.exp.close()


def _if_agent_run(specs, feed, features: bool, device: str,
                  udn_path: str) -> dict:
    """(c): one agent with the ring-buffer fallback, and with the three
    settings when `features`, fed `feed` by a `FakeFetcher` in a fixed
    order: the SSL writes (each handled), the singles (each accounted),
    then the map eviction, all evicted at stop (1 h timeouts), so every
    run folds the same records in the same batches."""
    import os
    import threading
    import torch
    from netobserv_tpu_torch.agent import FlowsAgent, Status
    from netobserv_tpu_torch.config import load_config
    from netobserv_tpu_torch.datapath.fetcher import EvictedFlows, FakeFetcher
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    from netobserv_tpu_torch.metrics.registry import Metrics, MetricsSettings
    from netobserv_tpu_torch.sketch import state as sk
    from netobserv_tpu_torch.utils import ovn_decoder
    import gc
    agg, singles, ssl, owned = feed
    # FORCE_GARBAGE_COLLECTION at its default: the map tracer collects the
    # whole heap after the record path's first eviction of each active
    # timeout, where every single asks for an eviction (ROADMAP C2, C5)
    env = {"EXPORT": "tpu-sketch", "AGENT_IP": "127.0.0.1",
           "ENABLE_FLOWS_RINGBUF_FALLBACK": "true",
           "CACHE_ACTIVE_TIMEOUT": "1h", "SKETCH_WINDOW": "1h",
           "CACHE_MAX_FLOWS": str(4 * IF_RB_FLOWS)}
    if features:
        env.update(ENABLE_OPENSSL_TRACKING="true", ENABLE_UDN_MAPPING="true",
                   ENABLE_NETWORK_EVENTS_MONITORING="true")
    if device == "cpu":
        env.update(SKETCH_DEVICES="cpu", SKETCH_CM_WIDTH="4096",
                   SKETCH_TOPK="256", SKETCH_HLL_PRECISION="10")
    cfg = load_config(env)
    cfg.validate()
    metrics = Metrics(MetricsSettings())
    sink = WindowSink()
    exp = TorchSketchExporter.from_config(cfg, metrics=metrics, sink=sink)
    rolls: list = []  # a device clone of each pre-roll state
    roll_locked = exp._roll_locked

    def keep_state(*args):
        rolls.append(_clone(exp.state))
        return roll_locked(*args)
    exp._roll_locked = keep_state
    tap = _RecordPath(exp)
    fake = FakeFetcher()
    saved_udn = os.environ.get("UDN_MAPPING_FILE")
    os.environ["UDN_MAPPING_FILE"] = udn_path
    try:
        agent = FlowsAgent(cfg, fake, tap, metrics=metrics)
    finally:
        if saved_udn is None:
            del os.environ["UDN_MAPPING_FILE"]
        else:
            os.environ["UDN_MAPPING_FILE"] = saved_udn
    handled = []
    decoder = None
    if features:
        check(agent.ssl_tracer is not None
              and agent.ssl_correlator is not None
              and agent.accounter._ssl_correlator is agent.ssl_correlator,
              "the SSL branch was not built")
        agent.ssl_correlator._resolver = lambda pid: list(owned.get(pid, []))
        handle = agent.ssl_tracer._handler

        def counted(event):
            handle(event)
            handled.append(1)
        agent.ssl_tracer._handler = counted
        decoder = ovn_decoder.active_decoder()
        check(decoder is agent._ovn_decoder, "the OVN decoder not installed")
    stages = sorted(agent.supervisor.snapshot())

    def wait(pred, what: str, secs: float = 20.0) -> None:
        deadline = time.monotonic() + secs
        while not pred() and time.monotonic() < deadline:
            time.sleep(0.002)
        check(pred(), f"timed out waiting for {what}")

    # the full collections of the run (the map tracer's and the
    # interpreter's own) and their seconds
    collects: list = []

    def on_gc(phase, info):
        if info["generation"] == 2:
            collects.append((phase, time.perf_counter()))
    stop = threading.Event()
    runner = threading.Thread(target=agent.run, args=(stop,), daemon=True)
    gc.callbacks.append(on_gc)
    runner.start()
    try:
        wait(lambda: agent.status == Status.STARTED, "the agent to start")
        if features:
            for raw in ssl:
                fake.inject_ssl(raw)
            wait(lambda: len(handled) == len(ssl), "the SSL writes")
        for i in range(len(singles)):
            # paced as `ringbuf` paces them, so that none is dropped
            wait(lambda: fake._ringbuf.qsize() + agent._rb_q.qsize()
                 < RB_BACKLOG, "room for the singles")
            fake.inject_ringbuf(singles[i:i + 1])

        def accounted() -> bool:
            try:
                packets = sum(int(e["stats"]["packets"]) for e in
                              list(agent.accounter._entries.values()))
            except RuntimeError:  # resized under the accounter's thread
                return False
            return (metrics.ringbuf_events_total._value.get()
                    == len(singles) and packets == len(singles))
        wait(accounted, "the singles")
        fake.inject_eviction(EvictedFlows(agg))
    finally:
        stop.set()
        runner.join(timeout=30)
        gc.callbacks.remove(on_gc)
    check(not runner.is_alive() and agent.status == Status.STOPPED,
          f"the agent did not stop ({agent.status})")
    if device != "cpu":
        torch.cuda.synchronize()
    records = [r for b in tap.batches for r in b]
    check(len(records) == len(agg) + len(
        {k.tobytes() for k in singles["key"]}),
        f"{len(records)} records")
    credits = sorted(
        (r.key.src_ip + r.key.dst_ip, r.key.src_port, r.key.dst_port,
         r.features.ssl_plaintext_events, r.features.ssl_plaintext_bytes)
        for r in records if r.features.ssl_plaintext_events)
    # (first octet of the source: 10 the map's flows, 11 the singles',
    # interface, UDN)
    udns = sorted({(r.key.src_ip[12], r.interface, r.udn) for r in records})
    check(len(rolls) == 1, f"{len(rolls)} rolls")
    return {"tables": sk.state_tables(rolls[0]),
            "reports": [{k: v for k, v in rep.items()
                         if k != "TimestampMs"} for rep in sink.reports],
            "credits": credits, "udns": udns, "stages": stages,
            "decoder": type(decoder).__name__ if decoder else None,
            "decoder_after": type(ovn_decoder.active_decoder()).__name__,
            "records": len(records), "batches": len(tap.batches),
            "folds": exp.folds,
            "full_collects": sum(p == "stop" for p, _t in collects),
            "collect_s": sum(t1 - t0 for (p0, t0), (p1, t1)
                             in zip(collects, collects[1:])
                             if p0 == "start" and p1 == "stop")}


def phase_ifaces_features(specs, card: str) -> dict:
    """Interface discovery and the SSL, UDN and network-events branches
    on the card (module docstring, `ifaces_features`)."""
    import faulthandler
    # a phase that overruns half its budget leaves every thread's stack
    faulthandler.dump_traceback_later(IF_BUDGET_S / 2, file=sys.stderr)
    try:
        return _ifaces_features(specs, card)
    finally:
        faulthandler.cancel_dump_traceback_later()


def _ifaces_features(specs, card: str) -> dict:
    import errno
    import os
    import tempfile
    import numpy as np
    from netobserv_tpu_torch.ifaces import netlink
    t_phase = time.perf_counter()
    out = {"phase": "ifaces_features", "card": card}
    # (a) the netlink dump against a listing made without netlink
    witness = _link_witness()
    try:
        links = [(lk.index, lk.name, lk.mac, lk.up)
                 for lk in netlink.dump_links()]
    except OSError as exc:
        code = errno.errorcode.get(exc.errno, exc.errno)
        print(f"ifaces_features: the netlink socket refused ({code})",
              flush=True)
        links = None
    if links is None or witness is None:
        why = ("the netlink socket refused" if links is None
               else "no listing of the interfaces without netlink")
        print(f"ifaces_features: part (a) not run: {why}", flush=True)
        out["netlink"] = f"not run: {why}"
    else:
        source, want = witness
        got = {n: i for i, n, _m, _u in links}
        check(got == want, f"netlink {got} against {source} {want}")
        out["netlink"] = {"links": len(links), "equal_to": source}
        print(f"ifaces_features: (a) netlink's {len(links)} links equal "
              f"{source}'s", flush=True)
    # (b) the listener
    if links is not None:
        out["listener"] = _if_listener(links, "netlink")
    else:
        out["listener"] = _if_listener(IF_SCRIPTED_LINKS, "scripted")
    out["netlink_and_listener_s"] = time.perf_counter() - t_phase
    print(f"ifaces_features: (a) and (b) took "
          f"{out['netlink_and_listener_s']:.2f} s", flush=True)
    # (c) the three settings on the card, without them, and on the CPU
    feed = _if_feed(np.random.default_rng(IF_SEED))
    check(int(feed[0]["stats"]["bytes"].sum())
          + int(feed[1]["stats"]["bytes"].sum()) < 1 << 24,
          "the feed leaves the integer regime")
    plains: dict = {}
    runs = {}

    def run(name: str, features: bool, device: str) -> None:
        t0 = time.perf_counter()
        runs[name] = _if_agent_run(specs, feed, features, device, udn_path)
        out[f"{name}_run_s"] = time.perf_counter() - t0
        out[f"{name}_full_collects"] = runs[name]["full_collects"]
        print(f"ifaces_features: the {name} run took "
              f"{out[name + '_run_s']:.2f} s, {runs[name]['full_collects']} "
              f"full collections in {runs[name]['collect_s']:.3f} s",
              flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        udn_path = os.path.join(tmp, "udn.json")
        with open(udn_path, "w") as fh:
            json.dump(IF_UDNS, fh)
        with counting_plains(specs, plains):
            for s in specs:
                s["kernel"].launches = 0
            run("on", True, "cuda")
            launches = {s["name"]: s["kernel"].launches for s in specs}
            run("off", False, "cuda")
        # the CPU run's folds are the plain versions, counted by nothing
        run("cpu", True, "cpu")
    on, off, cpu = runs["on"], runs["off"], runs["cpu"]
    check(not plains, f"plain versions ran: {plains}")
    diff = [k for k in on["tables"]
            if not np.array_equal(on["tables"][k], off["tables"][k])]
    check(not diff and on["reports"] == off["reports"],
          f"tables {diff} differ with the three settings")
    check(on["credits"] == cpu["credits"] and on["credits"],
          f"{len(on['credits'])} credited records, the CPU run's "
          f"{len(cpu['credits'])}")
    # the map tracer names UDNs; the accounter's records carry none, as
    # the reference's (`flow/map_tracer.py:254-261`, `accounter.py`)
    check(on["udns"] == cpu["udns"] and all(
        u == (IF_UDNS.get(i, "") if octet == 10 else "")
        for octet, i, u in on["udns"]), f"udns {on['udns']}")
    check({"ssl-tracer", "accounter", "ringbuf-tracer"} <= set(on["stages"])
          and "ssl-tracer" not in off["stages"],
          f"stages {on['stages']} / {off['stages']}")
    check(on["decoder"] == "StaticCookieDecoder" or os.path.exists(
        "/var/run/ovn/ovnnb_db.sock"), f"decoder {on['decoder']}")
    check(on["decoder_after"] == "StaticCookieDecoder",
          f"decoder after shutdown {on['decoder_after']}")
    check(all(launches[n] > 0 for n in ("countmin_fold2", "topk_reduce",
                                         "signal_fold", "hll_fold_folds")),
          f"launches {launches}")
    out.update(
        launches=launches, records=on["records"], folds=on["folds"],
        record_batches=on["batches"], credited_records=len(on["credits"]),
        credits_equal_cpu=True, tables_equal_without=True,
        udns=on["udns"], decoder=on["decoder"],
        report_records=[r["Records"] for r in on["reports"]])
    out["seconds"] = time.perf_counter() - t_phase
    print(f"ifaces_features: {out['seconds']:.2f} s", flush=True)
    check(out["seconds"] <= IF_BUDGET_S,
          f"the phase took {out['seconds']:.1f} s of {IF_BUDGET_S}")
    return out


#: the scenarios phase: the zoo runner's batch, the scenarios whose folds
#: the kernel check records, and the recorded calls of each kernel it
#: holds against the kernel's twin
ZOO_BATCH = 512
ZOO_KERNEL_SCENARIOS = ("overlay_syn_scan", "elephant_mice", "ipv6_heavy")
ZOO_CHECK_CALLS = 4
#: the kernels of the zoo's path (the resident feed): kernels 1, 2, 4, the
#: folds launch, and kernels 3 and 8 as cut from the folds launch's calls
ZOO_KERNELS = ("countmin_fold2", "topk_reduce", "signal_fold",
               "hll_fold_folds", "hll_fold", "hll_fold_grid")


def _zoo_kernel_check(specs) -> list:
    """Each kernel of the zoo's path held against its plain twin at the
    zoo's shapes (module docstring, `scenarios`): the pcaps of
    ZOO_KERNEL_SCENARIOS evicted as the replay fetcher evicts them into an
    eager exporter of the runner's geometry and batch running the plain
    versions, every wrapper call recorded; the first, middle and last of
    up to ZOO_CHECK_CALLS calls of each kernel compared in the production
    and the integer regime."""
    import os
    import tempfile
    from netobserv_tpu_torch.datapath.replay import PcapReplayFetcher
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    from netobserv_tpu_torch.scenarios import runner, zoo
    calls: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ZOO_KERNEL_SCENARIOS:
            pcap = os.path.join(tmp, f"{name}.pcap")
            zoo.SCENARIOS[name](pcap)
            fetcher = PcapReplayFetcher(pcap, window_s=5.0)
            exp = TorchSketchExporter(
                runner._sketch_cfg(), batch_size=ZOO_BATCH, device="cuda",
                capture=False, sink=_discard, pack_threads=1,
                superbatch=(1,))
            try:
                with plain_versions(specs), recording(specs, calls):
                    while not fetcher.exhausted():
                        exp.export_evicted(fetcher.lookup_and_delete())
                    exp.flush()
            finally:
                exp.close()
    out = []
    for s in specs:
        if s["name"] not in ZOO_KERNELS:
            continue
        recs = _calls_of(s, calls)
        check(len(recs) >= 1, f"{s['name']}: the zoo's path never called it")
        picks = sorted({0, len(recs) // 2, len(recs) - 1})[:ZOO_CHECK_CALLS]
        cases = []
        for ci in picks:
            args = recs[ci]
            for regime, a in (("production", args),
                              ("integer", integer_inputs(s, args))):
                r = compare(s, a, regime)
                r.update(call=ci, regime=regime)
                cases.append(r)
        out.append({"name": s["name"], "calls": len(recs),
                    "shapes": [list(t.shape) for t in _tensors(recs[0])],
                    "max_abs_err": max(c["max_abs_err"] for c in cases),
                    "bounds": sorted({c["bound"] for c in cases}),
                    "cases": len(cases)})
    return out


def phase_scenarios(specs, card: str) -> dict:
    """The scenario zoo graded end to end on the card (module docstring,
    `scenarios`)."""
    import tempfile
    import torch
    from netobserv_tpu_torch.scenarios import runner, zoo
    t_phase = time.perf_counter()
    kernels = _zoo_kernel_check(specs)
    emit({"phase": "scenarios_kernels", "card": card, "batch": ZOO_BATCH,
          "kernels": kernels})
    total = {s["name"]: 0 for s in specs}
    lines, bad = [], []
    for name in zoo.SCENARIOS:
        for s in specs:
            s["kernel"].launches = 0
        plains: dict = {}
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp, \
                counting_plains(specs, plains):
            r = runner.run_scenario(name, tmp, device="cuda")
        torch.cuda.synchronize()
        launches = {s["name"]: s["kernel"].launches for s in specs}
        folds = r["folds"] + r["captures"]
        want = _want_launches(specs, "resident", folds)
        line = {"phase": "scenario", "card": card, "name": name,
                "passed": r["passed"], "failures": r["failures"],
                "alarms_fired": r.get("alarms_fired"),
                "alerts_raised": r.get("alerts_raised"),
                "time_to_detect_s": r.get("time_to_detect_s"),
                "retraces": r["retraces"],
                "seconds": time.perf_counter() - t0,
                "folds": r["folds"], "captures": r["captures"],
                "records": r["records"],
                "launches_per_fold": {k: v / folds
                                      for k, v in launches.items() if v},
                "plain_calls": plains,
                **{k: r[k] for k in ("topk_recall", "distinct_src_err",
                                     "dns_p50_us", "quic_records",
                                     "frequency_est_bytes",
                                     "resident_spill_rows",
                                     "dense_fallbacks") if k in r}}
        emit(line)
        lines.append(line)
        for k, v in launches.items():
            total[k] += v
        if not r["passed"] or r["retraces"]:
            bad.append(f"{name}: {r['failures']}, {r['retraces']} retraces")
        if plains:
            bad.append(f"{name}: plain versions ran {plains}")
        if launches != want or not all(launches[n] for n, v in want.items()
                                       if v):
            bad.append(f"{name}: launches {launches}, want {want}")
    check(not bad, "; ".join(bad))
    return {"phase": "scenarios", "card": card, "scenarios": len(lines),
            "passed": sum(x["passed"] for x in lines),
            "seconds_per_scenario": {x["name"]: x["seconds"] for x in lines},
            "time_to_detect_s": {x["name"]: x["time_to_detect_s"]
                                 for x in lines},
            "launches": total, "seconds": time.perf_counter() - t_phase}


#: the ringbuf phase: single-packet events injected, the flows they
#: cover (Zipf RB_ZIPF), the seed, and the events the feeder keeps ahead
#: of the accounter (below the tracer's queue of 10 x BUFFERS_LENGTH =
#: 500, so none drops) and injects at once
RB_EVENTS = 200_000
RB_FLOWS = 20_000
RB_ZIPF = 1.1
RB_SEED = 20
RB_BACKLOG = 256
RB_CHUNK = 64


def _rb_events(rng):
    """RB_EVENTS single-packet flow events over RB_FLOWS Zipf-skewed v4
    flows, as the datapath sends them when its map is full: 40-79 bytes
    (a SYN or an ACK: the whole stream stays below 2^24 bytes, so every
    per-cell sum is an integer f32 adds exactly), one packet, a TCP flag,
    rising times, one of three interfaces."""
    import numpy as np
    from netobserv_tpu_torch.model import binfmt
    keys = np.zeros(RB_FLOWS, binfmt.FLOW_KEY_DTYPE)
    for side in ("src_ip", "dst_ip"):
        keys[side][:, 10:12] = 0xFF
        keys[side][:, 12:] = rng.integers(0, 256, (RB_FLOWS, 4))
    keys["src_port"] = rng.integers(1024, 65536, RB_FLOWS)
    keys["dst_port"] = rng.choice([53, 80, 443, 8080], RB_FLOWS)
    keys["proto"] = 6
    weights = 1.0 / np.arange(1, RB_FLOWS + 1) ** RB_ZIPF
    ranks = rng.choice(RB_FLOWS, RB_EVENTS, p=weights / weights.sum())
    ev = np.zeros(RB_EVENTS, binfmt.FLOW_EVENT_DTYPE)
    ev["key"] = keys[ranks]
    st = ev["stats"]
    st["bytes"] = rng.integers(40, 80, RB_EVENTS)
    st["packets"] = 1
    st["tcp_flags"] = rng.choice([0x02, 0x10, 0x12, 0x18], RB_EVENTS)
    st["first_seen_ns"] = 10**12 + np.cumsum(
        rng.integers(1, 1000, RB_EVENTS))
    st["last_seen_ns"] = st["first_seen_ns"]
    st["eth_protocol"] = 0x0800
    st["if_index_first"] = rng.integers(1, 4, RB_EVENTS)
    return ev


def _key_sums(keys, nbytes, npkts) -> dict:
    """Key bytes (a row of `keys`: flow keys or their packed words) ->
    (bytes, packets) summed over rows."""
    import numpy as np
    kv = np.ascontiguousarray(keys).view(np.uint8).reshape(len(keys), -1)
    uniq, inv = np.unique(kv, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    b = np.bincount(inv, weights=nbytes.astype(np.float64))
    p = np.bincount(inv, weights=npkts.astype(np.float64))
    return {u.tobytes(): (int(x), int(y)) for u, x, y in zip(uniq, b, p)}


def phase_ringbuf(specs, card: str) -> dict:
    """The ring-buffer fallback on the card (module docstring,
    `ringbuf`)."""
    import dataclasses
    import threading
    import numpy as np
    import torch
    from netobserv_tpu_torch.agent import FlowsAgent, Status
    from netobserv_tpu_torch.config import load_config
    from netobserv_tpu_torch.datapath.fetcher import FakeFetcher
    from netobserv_tpu_torch.exporter import torch_sketch
    from netobserv_tpu_torch.metrics.registry import Metrics, MetricsSettings
    from netobserv_tpu_torch.model.columnar import pack_key_words
    from netobserv_tpu_torch.sketch import state as sk
    t_phase = time.perf_counter()
    ev = _rb_events(np.random.default_rng(RB_SEED))
    raw, size = ev.tobytes(), ev.dtype.itemsize
    items = [raw[i * size:(i + 1) * size] for i in range(len(ev))]
    cfg = load_config({"EXPORT": "tpu-sketch", "AGENT_IP": "127.0.0.1",
                       "ENABLE_FLOWS_RINGBUF_FALLBACK": "true",
                       "SKETCH_WINDOW": "10m"})
    cfg.validate()
    metrics = Metrics(MetricsSettings())
    exp = torch_sketch.TorchSketchExporter.from_config(cfg, metrics=metrics,
                                                       sink=_discard)
    fake = FakeFetcher()
    agent = FlowsAgent(cfg, fake, exp, metrics=metrics)
    batches, export_s = [], []
    export = agent.terminal._export

    def tapped(recs):
        t0 = time.perf_counter()
        export(recs)
        export_s.append(time.perf_counter() - t0)
        batches.append(recs)
    agent.terminal._export = tapped

    def events_in() -> int:
        return int(metrics.ringbuf_events_total._value.get())

    def packets_out() -> int:
        return sum(r.packets for b in batches for r in b)

    def wait(pred, secs: float, what: str) -> None:
        deadline = time.monotonic() + secs
        while not pred() and time.monotonic() < deadline:
            time.sleep(0.001)
        check(pred(), f"timed out waiting for {what}")

    for s in specs:
        s["kernel"].launches = 0
    plains: dict = {}
    stop = threading.Event()
    runner = threading.Thread(target=agent.run, args=(stop,), daemon=True)
    with counting_plains(specs, plains):
        runner.start()
        try:
            wait(lambda: agent.status == Status.STARTED, 10, "the agent")
            t0 = time.perf_counter()
            i = 0
            while i < len(items):
                if (fake._ringbuf.qsize() + agent._rb_q.qsize()
                        >= RB_BACKLOG):
                    time.sleep(0.0002)
                    continue
                for b in items[i:i + RB_CHUNK]:
                    fake.inject_ringbuf(b)
                i += RB_CHUNK
            wait(lambda: events_in() == len(items) and fake._ringbuf.empty()
                 and agent._rb_q.empty(), 60, "the tracer")
            t1 = time.perf_counter()
            # the accounter's last eviction comes at its timeout
            wait(lambda: packets_out() == len(items),
                 cfg.cache_active_timeout + 30, "the evictions")
            t2 = time.perf_counter()
            with exp._lock:
                exp._drain_pending()
                tables = sk.state_tables(exp.state)
            torch.cuda.synchronize()
            captures = sum(c.captures for c in exp.captures)
            folds = exp.folds
            report = exp.roll()
            launches = {s["name"]: s["kernel"].launches for s in specs}
        finally:
            stop.set()
            runner.join(timeout=30)
    check(not runner.is_alive() and agent.status == Status.STOPPED,
          f"the agent did not stop ({agent.status})")
    n_rec = sum(len(b) for b in batches)
    dropped = sum(m.value for fam in metrics.dropped_flows_total.collect()
                  for m in fam.samples if m.name.endswith("_total"))
    check(events_in() == len(items),
          f"ringbuf_events_total {events_in()}, injected {len(items)}")
    check(dropped == 0, f"{dropped} flows dropped")
    check(not plains, f"plain versions ran {plains}")
    want = _want_launches(specs, "wide", folds + captures)
    check(launches == want and all(launches[n] for n, v in want.items()
                                   if v),
          f"launches {launches}, want {want}")
    rec = torch_sketch._records_to_arrays([r for b in batches for r in b])
    got = _key_sums(rec["keys"], rec["bytes"], rec["packets"])
    check(got == _key_sums(pack_key_words(ev["key"]), ev["stats"]["bytes"],
                           ev["stats"]["packets"]),
          "the accounter's per-flow bytes and packets differ from the "
          "injected sums")
    total_bytes = int(ev["stats"]["bytes"].sum())
    check(total_bytes < 2 ** 24, f"{total_bytes} bytes leave the integer "
          "regime")
    check(report["Records"] == float(n_rec)
          and report["Bytes"] == float(total_bytes),
          f"report {report['Records']} records, {report['Bytes']} bytes")
    at_max = sum(len(b) == cfg.cache_max_flows for b in batches)
    check(at_max > 0 and len(batches) > at_max,
          f"{at_max} of {len(batches)} evictions at CACHE_MAX_FLOWS: want "
          "some on max_entries and some on the timeout")
    # the same record lists through a CPU exporter of the same settings
    t3 = time.perf_counter()
    cpu = torch_sketch.TorchSketchExporter.from_config(
        dataclasses.replace(cfg, sketch_devices="cpu"), sink=_discard)
    try:
        for b in batches:
            cpu.export_batch(b)
        with cpu._lock:
            cpu._drain_pending()
            want_tables = sk.state_tables(cpu.state)
        cpu_folds = cpu.folds
    finally:
        cpu.close()
    diff = [k for k in want_tables
            if not np.array_equal(tables[k], want_tables[k])]
    check(tables.keys() == want_tables.keys() and not diff,
          f"tables {diff} differ from the CPU replay")
    check(cpu_folds == folds, f"{folds} folds on the card, {cpu_folds} on "
          "the CPU")
    ms = [x * 1e3 for x in export_s]
    return {"phase": "ringbuf", "card": card, "events": len(items),
            "flows_touched": len(got), "zipf_s": RB_ZIPF,
            "evictions": len(batches), "evictions_at_max_entries": at_max,
            "records": n_rec, "folds": folds, "captures": captures,
            "batch_size": exp.batch_size,
            "geometry": {"cm_depth": exp.cfg.cm_depth,
                         "cm_width": exp.cfg.cm_width,
                         "hll_precision": exp.cfg.hll_precision,
                         "topk": exp.cfg.topk},
            "events_per_s_tracer_accounter": len(items) / (t1 - t0),
            "seconds_to_last_eviction": t2 - t0,
            "export_seconds": sum(export_s), "export_ms": _pcts(ms),
            "fold_seconds_per_record": sum(export_s) / n_rec,
            "tables_bit_equal_cpu_replay": len(want_tables),
            "cpu_replay_seconds": time.perf_counter() - t3,
            "launches": launches, "seconds": time.perf_counter() - t_phase}


#: the stack ladder (`tenants` (a)): tenant counts, rows a tenant a
#: dispatch, timed and warm-up dispatches, and the dispatches held bit for
#: bit against the plain versions
TN_LADDER = (1, 8, 64)
TN_B = 32
TN_ITERS = 24
TN_WARMUP = 3
TN_CHECK = 2
#: the router's recall block: tenants, rows a tenant a dispatch, folds of
#: Zipf-1.2 rows over a universe, and the byte masses (integers whose
#: per-cell sums stay below 2^24, so the plain replay is exact)
TN_RECALL = dict(n=8, batch=256, folds=200, rows=512, universe=4096,
                 zipf=1.2, bytes=(64, 513))
#: the exporter's tenants (`tenants` (b)) and windows
TN_EXP_N = 8
TN_EXP_WINDOWS = 2


def _tenant_bufs(rng, n: int, count: int = 8) -> list:
    """`count` stacked slots of n tenants x TN_B rows (the reference bench's
    rows, `bench.py:1173-1186`): random keys, integer-valued bytes
    64-8999, packets 1-11, every row valid."""
    import numpy as np
    from netobserv_tpu_torch.sketch.state import DENSE_WORDS
    out = []
    for _ in range(count):
        rows = np.zeros((n, TN_B, DENSE_WORDS), np.uint32)
        rows[..., :10] = rng.integers(0, 2**32, (n, TN_B, 10),
                                      dtype=np.uint32)
        rows[..., 10] = rng.integers(64, 9000, (n, TN_B)).astype(
            np.float32).view(np.uint32)
        rows[..., 11] = rng.integers(1, 12, (n, TN_B))
        rows[..., 14] = 1
        out.append(rows)
    return out


def _tables_equal(a: dict, b: dict) -> list:
    """The names of the tables that differ in any bit."""
    import numpy as np
    return [k for k in a if not np.array_equal(a[k], b[k])]


def _stack_rung(specs, cfg, n: int, graph_pool) -> dict:
    """One rung of the ladder (module docstring, `tenants` (a)): the
    stacked arm, the sequential arm, the launches and the bit-exact
    check against eager plain folds."""
    import gc
    import numpy as np
    import torch
    from netobserv_tpu_torch.sketch import state as sk
    from netobserv_tpu_torch.sketch import tenancy
    from netobserv_tpu_torch.sketch.capture import CapturedFold
    from netobserv_tpu_torch.utils import tracing
    bufs = _tenant_bufs(np.random.default_rng(7 + n), n)
    names = {s["kernel"]: s["name"] for s in specs}
    # stacked arm: the production stack, one slot copy and one replay a
    # dispatch of every tenant's TN_B rows
    stack = tenancy.TenantStack(n, cfg, TN_B, graph_pool=graph_pool)
    state = tenancy.init_stacked_state(cfg, n)
    torch.cuda.synchronize()
    # a capture empties the allocator's cache as it starts: empty it
    # first, so that what the capture adds is its graph's pool
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    stack.warm(state)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    pool_bytes = torch.cuda.memory_reserved() - reserved
    per_dispatch = {names[k]: v for k, v in stack.captured.launches.items()}
    want = _want_launches(specs, "wide", n)
    check(per_dispatch == {k: v for k, v in want.items() if v},
          f"n={n}: launches a stacked dispatch {per_dispatch}, want {want}")

    def stacked(i: int) -> None:
        stack._fillbuf[...] = bufs[i % len(bufs)]
        stack._fill = [TN_B] * n
        stack._dispatch(state, tracing.NULL_TRACE)

    def timed(body) -> tuple[float, float]:
        for i in range(TN_WARMUP):
            body(i)
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        for i in range(TN_ITERS):
            body(i)
        ev1.record()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, ev0.elapsed_time(ev1) / TN_ITERS

    for s in specs:
        s["kernel"].launches = 0
    stacked_s, stacked_ms = timed(stacked)
    launches = {s["name"]: s["kernel"].launches for s in specs}
    want = _want_launches(specs, "wide", n * (TN_WARMUP + TN_ITERS))
    check(launches == want, f"n={n}: stacked launches {launches}, want "
          f"{want}")
    # sequential arm: n single-tenant captured folds of the same rows, each
    # its own copy to the card (from pinned buffers made once) and replay
    seq_state = tenancy.init_stacked_state(cfg, n)
    views = [tenancy.tenant_view(seq_state, t) for t in range(n)]
    hosts = [torch.from_numpy(b.reshape(n, -1).view(np.int32)).pin_memory()
             for b in bufs]
    dev = torch.zeros((n, TN_B * sk.DENSE_WORDS), dtype=torch.int32,
                      device=stack.device)

    def one(s, flat):
        sk.ingest(s, sk.dense_to_arrays(flat))

    folds = [CapturedFold(f"tenant_seq_n{n}", one, graph_pool)
             for _ in range(n)]
    t0 = time.perf_counter()
    for t in range(n):
        folds[t].prepare(views[t], dev[t])
    torch.cuda.synchronize()
    seq_capture_s = time.perf_counter() - t0

    def sequential(i: int) -> None:
        host = hosts[i % len(hosts)]
        for t in range(n):
            dev[t].copy_(host[t], non_blocking=True)
            folds[t](views[t], dev[t])

    seq_s, seq_ms = timed(sequential)
    rows = n * TN_B * TN_ITERS
    # the stacked graph on a fresh state, TN_CHECK dispatches, against
    # each tenant's eager plain fold of the same rows
    sk.copy_state_(state, tenancy.init_stacked_state(cfg, n))
    for i in range(TN_CHECK):
        stacked(i)
    with plain_versions(specs):
        for t in range(n):
            one_state = sk.init_state(cfg)
            for i in range(TN_CHECK):
                flat = torch.from_numpy(
                    bufs[i][t].reshape(-1).view(np.int32)).cuda()
                sk.ingest(one_state, sk.dense_to_arrays(flat))
            diff = _tables_equal(
                sk.state_tables(tenancy.tenant_view(state, t)),
                sk.state_tables(one_state))
            check(not diff, f"n={n} tenant {t}: tables {diff} differ from "
                  "the eager plain folds")
    watch = stack.captured.stats()
    check(watch["compiles"] == 1 and watch["retraces"] == 0
          and watch["tenants"] == n, f"n={n}: tenant_ingest {watch}")
    stack.close()
    return {"tenants": n, "rows_a_tenant": TN_B,
            "stacked_records_per_s": rows / stacked_s,
            "sequential_records_per_s": rows / seq_s,
            "stacked_over_sequential": seq_s / stacked_s,
            "stacked_dispatch_ms": stacked_ms,
            "sequential_round_ms": seq_ms,
            "launches_per_stacked_dispatch": per_dispatch,
            "capture_seconds": capture_s,
            "sequential_capture_seconds": seq_capture_s,
            "graph_pool_bytes": pool_bytes,
            "stacked_state_bytes": sum(
                x.numel() * x.element_size() for x in _tensors(state)),
            "bit_exact_tenants": n}


def _recall_block(specs, cfg, graph_pool) -> dict:
    """`tenants` (a)'s router block: Zipf rows through `fold_rows`, every
    tenant's recall@100 against its exact oracle, and its tables bit for
    bit against an eager stack of the plain versions fed the same rows."""
    import numpy as np
    import torch
    from netobserv_tpu_torch.ops import hashing
    from netobserv_tpu_torch.sketch import state as sk
    from netobserv_tpu_torch.sketch import tenancy
    p = TN_RECALL
    n = p["n"]
    rng = np.random.default_rng(7)
    universe = rng.integers(0, 2**32, (p["universe"], 10), dtype=np.uint32)
    exact = np.zeros(p["universe"])
    batches = []
    for _ in range(p["folds"]):
        ranks = np.minimum(rng.zipf(p["zipf"], p["rows"]) - 1,
                           p["universe"] - 1)
        nbytes = rng.integers(*p["bytes"], p["rows"]).astype(np.float32)
        rows = np.zeros((p["rows"], sk.DENSE_WORDS), np.uint32)
        rows[:, :10] = universe[ranks]
        rows[:, 10] = nbytes.view(np.uint32)
        rows[:, 11] = 1
        rows[:, 14] = 1
        batches.append(rows)
        exact += np.bincount(ranks, weights=nbytes, minlength=len(exact))
    stack = tenancy.TenantStack(n, cfg, p["batch"], graph_pool=graph_pool)
    state = tenancy.init_stacked_state(cfg, n)
    stack.warm(state)
    t0 = time.perf_counter()
    for rows in batches:
        stack.fold_rows(state, rows)
    stack.flush(state)
    torch.cuda.synchronize()
    fold_s = time.perf_counter() - t0
    with plain_versions(specs):
        plain = tenancy.TenantStack(n, cfg, p["batch"], capture=False)
        pstate = tenancy.init_stacked_state(cfg, n)
        for rows in batches:
            plain.fold_rows(pstate, rows)
        plain.flush(pstate)
    check(plain.folds == stack.folds, f"{plain.folds} plain dispatches, "
          f"{stack.folds} captured")
    owners = hashing.tenant_of_np(universe, n)
    recalls = []
    for t in range(n):
        got = sk.state_tables(tenancy.tenant_view(state, t))
        want = sk.state_tables(tenancy.tenant_view(pstate, t))
        diff = _tables_equal(got, want)
        check(not diff, f"recall block tenant {t}: tables {diff} differ "
              "from the plain replay")
        mine = np.flatnonzero(owners == t)
        top = mine[np.argsort(-exact[mine], kind="stable")[:100]]
        held = {tuple(w) for w, v in zip(got["heavy_words"],
                                         got["heavy_valid"]) if v}
        recalls.append(sum(tuple(universe[r]) in held for r in top)
                       / max(len(top), 1))
    check(min(recalls) >= 0.99, f"per-tenant recall@100 {recalls}")
    stack.close()
    plain.close()
    return {"tenants": n, "rows_a_tenant": p["batch"],
            "folds": p["folds"], "rows_a_fold": p["rows"],
            "stacked_dispatches": stack.folds,
            "recall_at_100": recalls,
            "records_per_s": p["folds"] * p["rows"] / fold_s}


def _tenant_cuts(n_rows: int, windows: int) -> list:
    """The lanes path's evictions (`_stream_evictions`) over `windows`
    passes of the stream, one list of (lo, hi) a pass."""
    gen = _stream_evictions(n_rows)
    out = []
    for _ in range(windows):
        cuts = []
        while not cuts or cuts[-1][1] < n_rows:
            cuts.append(next(gen))
        out.append(cuts)
    return out


def _tenant_exporter_run(exp, stream, cuts, specs) -> dict:
    """Feed `exp` the evictions of `cuts` (a window a list), rolling after
    each window; its reports, launches, roll and route timings."""
    import torch
    from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
    from netobserv_tpu_torch.utils import retrace
    ev_all, lanes_all = stream
    holds = []
    close_window = exp._close_window_locked

    def timed_close(*args):
        t0 = time.perf_counter()
        try:
            return close_window(*args)
        finally:
            holds.append((time.perf_counter() - t0) * 1e3)
    exp._close_window_locked = timed_close
    captures0 = [c.captures for c in exp.captures]
    retraces0 = retrace.total_retraces()
    folds0 = exp.ring.folds
    torch.cuda.synchronize()
    for s in specs:
        s["kernel"].launches = 0
    t0 = time.perf_counter()
    reports, roll_s = [], []
    for cut in cuts:
        for lo, hi in cut:
            exp.export_evicted(EvictedFlows(
                ev_all[lo:hi], **{k: v[lo:hi] for k, v in lanes_all.items()}))
        t1 = time.perf_counter()
        reports.append(exp.roll())
        roll_s.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {s["name"]: s["kernel"].launches for s in specs}
    check([c.captures for c in exp.captures] == captures0
          and retrace.total_retraces() == retraces0,
          "a capture or retrace during the tenant run")
    return {"reports": reports, "launches": launches, "holds_ms": holds,
            "dispatches": exp.ring.folds - folds0, "wall": wall,
            "roll_s": roll_s,
            "rows": sum(hi - lo for cut in cuts for lo, hi in cut)}


def _route_ms(ring, stream, cuts) -> float:
    """Host ms per 16,384 rows of the router: `route` (the pack and
    `tenant_of_np`) and the per-tenant selection, over the evictions."""
    ev_all, lanes_all = stream
    t = rows = 0
    for lo, hi in cuts:
        t0 = time.perf_counter()
        packed, owners = ring.route(
            ev_all[lo:hi], **{k: v[lo:hi] for k, v in lanes_all.items()})
        for tn in range(ring.n_tenants):
            packed[owners == tn]
        t += time.perf_counter() - t0
        rows += hi - lo
    return t * 1e3 * BATCH / rows


def _plain_tenant_exporter(exp, frames: list):
    """An eager exporter of `exp`'s geometry and tenants, with a callable
    delta sink: under `plain_versions`, the plain routed replay."""
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    return TorchSketchExporter(
        exp.cfg, batch_size=exp.batch_size, device="cuda", capture=False,
        sink=_discard, tenants=exp.tenants, delta_sink=frames.append)


def _frames_of(frames: list, n: int, windows: int) -> list:
    """The decoded delta frames, a list of n a window."""
    from netobserv_tpu_torch.federation import delta as fdelta
    out = [fdelta.decode_frame(f) for f in frames[:n * windows]]
    return [out[w * n:(w + 1) * n] for w in range(windows)]


def _heavy_ids(t: dict) -> set:
    return {(int(h1), int(h2)) for h1, h2, v in zip(
        t["heavy_h1"], t["heavy_h2"], t["heavy_valid"]) if v}


def _tenant_exporter(extra: dict, frames: list):
    """The exporter `load_config` builds for SKETCH_TENANTS=TN_EXP_N at the
    default geometry and B = BATCH (windows closed by `roll`), with a
    callable delta sink (set on the built exporter)."""
    from netobserv_tpu_torch.config import load_config
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    cfg = load_config(_agent_env(SKETCH_TENANTS=str(TN_EXP_N),
                                 SKETCH_WINDOW="1h", **extra))
    cfg.validate()
    exp = TorchSketchExporter.from_config(cfg, sink=_discard)
    exp._delta_sink = frames.append
    return exp


def phase_tenants(specs, events, card: str) -> dict:
    """The tenant planes on the card (module docstring, `tenants`)."""
    import numpy as np
    import torch
    from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
    from netobserv_tpu_torch.model.columnar import pack_key_words
    from netobserv_tpu_torch.ops import hashing
    from netobserv_tpu_torch.sketch import state as sk
    from netobserv_tpu_torch.sketch import tenancy
    t_phase = time.perf_counter()
    cfg = sk.SketchConfig()
    # a graph pool a rung, so that each rung's capture shows its own
    ladder = [_stack_rung(specs, cfg, n, torch.cuda.graph_pool_handle())
              for n in TN_LADDER]
    recall = _recall_block(specs, cfg, torch.cuda.graph_pool_handle())
    # (b) the exporter on the lanes stream
    stream = LaneFeeder(events).stream
    n_rows = len(stream[0])
    cuts = _tenant_cuts(n_rows, TN_EXP_WINDOWS)
    owners = hashing.tenant_of_np(pack_key_words(stream[0]["key"]),
                                  TN_EXP_N)
    per_tenant = np.bincount(owners, minlength=TN_EXP_N).astype(float)
    frames: list = []
    exp = _tenant_exporter({}, frames)
    try:
        run = _tenant_exporter_run(exp, stream, cuts, specs)
        route_ms = _route_ms(exp.ring, stream, cuts[0])
        code, body = exp.query_routes.handle("/query/topk", {"tenant": "3"})
        check(code == 200 and body["topk"]
              == run["reports"][-1][3]["HeavyHitters"][:100],
              f"/query/topk?tenant=3: {code}")
        check([exp.query_routes.handle("/query/topk", p)[0]
               for p in ({}, {"tenant": "8"})] == [400, 404],
              "the tenant route contract")
        status = exp.query_status()["tenants"]
    finally:
        exp.close()
    for w, reps in enumerate(run["reports"]):
        check([r["Tenant"] for r in reps] == list(range(TN_EXP_N))
              and [r["Records"] for r in reps] == list(per_tenant),
              f"window {w}: records {[r['Records'] for r in reps]}, want "
              f"{list(per_tenant)}")
    check(run["rows"] == TN_EXP_WINDOWS * n_rows, "rows fed")
    want = _want_launches(specs, "wide", TN_EXP_N * run["dispatches"])
    check(run["launches"] == want, f"tenant launches {run['launches']}, "
          f"want {want}")
    # the plain routed replay: the same evictions, rolled at the same
    # points, each tenant's per-cell adds counted on its own
    pframes: list = []
    adds_by_window: list = []
    adds, touched = {}, {}
    with plain_versions(specs, adds, touched):
        pexp = _plain_tenant_exporter(exp, pframes)
        ring = pexp.ring
        cur: list = []

        def ingest(state, dev, _n=ring.n_tenants, _b=ring.batch_size):
            flat = dev.view(_n, _b * sk.DENSE_WORDS)
            for t in range(_n):
                sk.ingest(tenancy.tenant_view(state, t),
                          sk.dense_to_arrays(flat[t]))
                acc = cur[t]
                for k, v in adds.items():
                    acc[k] = acc[k] + v if k in acc else v.clone()
                adds.clear()
                touched.clear()
        ring._ingest = ingest
        try:
            ev_all, lanes_all = stream
            for cut in cuts:
                cur[:] = [{} for _ in range(TN_EXP_N)]
                for lo, hi in cut:
                    pexp.export_evicted(EvictedFlows(
                        ev_all[lo:hi],
                        **{k: v[lo:hi] for k, v in lanes_all.items()}))
                pexp.roll()
                adds_by_window.append([{k: v.cpu().numpy()
                                        for k, v in a.items()} for a in cur])
        finally:
            pexp.close()
    cmp = []
    got, ref = (_frames_of(f, TN_EXP_N, TN_EXP_WINDOWS)
                for f in (frames, pframes))
    for w in range(TN_EXP_WINDOWS):
        for t in range(TN_EXP_N):
            a, b = got[w][t], ref[w][t]
            check(a.tenant == (t, TN_EXP_N) and a.window == w,
                  f"frame {w}/{t}: tenant {a.tenant}, window {a.window}")
            cmp.append(compare_tables(a.tables, b.tables,
                                      adds_by_window[w][t]))
            check(_heavy_ids(a.tables) == _heavy_ids(b.tables),
                  f"window {w} tenant {t}: heavy identities differ from "
                  "the plain replay's")
    # an integer-mass copy, one window: bit for bit against the plain
    # routed replay
    ints = _integer_stream(events)
    iframes, ipframes = [], []
    iexp = _tenant_exporter({}, iframes)
    try:
        irun = _tenant_exporter_run(iexp, ints, cuts[:1], specs)
    finally:
        iexp.close()
    with plain_versions(specs):
        ipexp = _plain_tenant_exporter(iexp, ipframes)
        try:
            ev_all, lanes_all = ints
            for lo, hi in cuts[0]:
                ipexp.export_evicted(EvictedFlows(
                    ev_all[lo:hi],
                    **{k: v[lo:hi] for k, v in lanes_all.items()}))
            ipexp.roll()
        finally:
            ipexp.close()
    for t, (a, b) in enumerate(zip(*(_frames_of(f, TN_EXP_N, 1)[0]
                                     for f in (iframes, ipframes)))):
        diff = _tables_equal(a.tables, b.tables)
        check(not diff, f"integer window tenant {t}: tables {diff} differ")
    # one tiered window: kernels 6 and 7, N to a stacked dispatch
    tframes: list = []
    texp = _tenant_exporter({"SKETCH_TIERED": "true"}, tframes)
    try:
        trun = _tenant_exporter_run(texp, stream, cuts[:1], specs)
    finally:
        texp.close()
    twant = _want_launches(specs, "tiered", TN_EXP_N * trun["dispatches"])
    check(trun["launches"] == twant, f"tiered tenant launches "
          f"{trun['launches']}, want {twant}")
    check([r["Records"] for r in trun["reports"][0]] == list(per_tenant),
          "tiered records")
    # fault C14: the record path in tenant mode
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    records = _record_path(
        specs, events,
        lambda where: TorchSketchExporter(
            cfg, batch_size=BATCH, tenants=TN_EXP_N, sink=_discard,
            device=None if where == "card" else "cpu"),
        lambda exp: {f"{t}.{k}": v
                     for t, tab in enumerate(exp.state_tables())
                     for k, v in tab.items()})
    holds = run["holds_ms"]
    return {"phase": "tenants", "card": card, "ladder": ladder,
            "recall": recall, "record_path": records,
            "exporter": {
                "tenants": TN_EXP_N, "batch": BATCH,
                "windows": TN_EXP_WINDOWS, "records_fed": run["rows"],
                "stacked_dispatches": run["dispatches"],
                "records_per_s": run["rows"] / run["wall"],
                "records_per_s_between_rolls": run["rows"] / (
                    run["wall"] - sum(run["roll_s"])),
                "roll_publish_s": run["roll_s"],
                "route_ms_per_16384": route_ms,
                "roll_lock_hold_ms": holds,
                "records_per_tenant": list(per_tenant),
                "status": status, "vs_plain": cmp,
                "integer_window_exact": True,
                "tiered_dispatches": trun["dispatches"],
                "tiered_records_per_s": trun["rows"] / trun["wall"],
                "tiered_roll_lock_hold_ms": trun["holds_ms"]},
            "launches": run["launches"],
            "tiered_launches": trun["launches"],
            "seconds": time.perf_counter() - t_phase}


#: the mesh phase (module docstring, `mesh`): the grid's devices, a card
#: index a slot, and (a)'s integer-mass dispatches
MESH_SLOTS = 4
MESH_INT_FOLDS = 8


def mesh_devices() -> list:
    """`MESH_SLOTS` mesh devices over the visible cards, round robin: the
    one card repeated where there is one."""
    import torch
    n = torch.cuda.device_count()
    return [f"cuda:{i % n}" for i in range(MESH_SLOTS)]


def _mesh_want(specs, shard_folds: int, n_sketch: int) -> dict:
    """Launches over `shard_folds` shard folds of a mesh: a wide fold's
    each, kernel 1 traded for two launches of kernel 5 on a
    width-sharded mesh (bytes and packets, `countmin.update_sharded`)."""
    want = _want_launches(specs, "wide", shard_folds)
    if n_sketch > 1:
        want["countmin_fold2"] = 0
        want["countmin_fold"] = 2 * shard_folds
    return want


def _integer_dense(flat):
    """A dense batch with every summed mass a small integer (bytes 1-63,
    packets 1-3, drop bytes 0-63 and packets 0-3, unsampled): sums in any
    order are then exact."""
    import numpy as np
    rows = flat.reshape(-1, 20).copy()
    b = rows[:, 10].view(np.float32)
    rows[:, 10] = (1 + b.astype(np.int64) % 63).astype(np.float32).view(
        np.uint32)
    rows[:, 11] = 1 + rows[:, 11] % 3
    rows[:, 15] = 0
    rows[:, 17] = (rows[:, 17] & 0xFFFF) % 64 | (
        ((rows[:, 17] >> 16) % 4) << 16)
    return rows.reshape(-1)


class MeshDenseRun:
    """One run of (a): a dense ring (on the mesh, or on one card with
    `mesh` None) whose slots take the pool's dense batches as they are,
    folded and rolled window by window; the device ms of each dispatch
    (CUDA events around its copy and fold) and the wall of each window."""

    def __init__(self, cfg, mesh, capture: bool):
        import torch
        from netobserv_tpu_torch.parallel import merge as pmerge
        from netobserv_tpu_torch.sketch import staging
        from netobserv_tpu_torch.sketch import state as sk
        self.cfg, self.mesh = cfg, mesh
        self.ring = staging.DenseStagingRing(
            BATCH, device="cuda", mesh=mesh, capture=capture,
            graph_pool=torch.cuda.graph_pool_handle() if capture else None)
        if mesh is None:
            self.state = sk.init_state(cfg, "cuda")
        else:
            self.state = pmerge.init_dist_state(cfg, mesh)
            self.roll_fn = pmerge.make_merge_fn(
                mesh, cfg, with_tables=mesh.sketch == 1)
        self.ring.warm(self.state)
        self.device_ms: list = []

    def fold(self, flat) -> None:
        import torch
        ring = self.ring
        slot = ring._wait_slot()
        ring._bufs[slot][:] = flat
        ev0, ev1 = torch.cuda.Event(True), torch.cuda.Event(True)
        ev0.record()
        dev = ring._ship(slot)
        if self.mesh is None:
            ring._dispatch(ring.captured, ring._fold_fn, self.state, dev)
        else:
            ring._dispatch_mesh(self.state, dev)
        ev1.record()
        ring._advance(slot)
        self.device_ms.append((ev0, ev1))

    def roll(self):
        """(pre-roll tables or None, report, per-shard tables or None,
        roll seconds): the merged tables on a data-axis mesh, each shard's
        on a width-sharded one."""
        import torch
        from netobserv_tpu_torch.sketch import state as sk
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shards = None
        if self.mesh is None:
            tables = sk.state_tables(self.state)
            _, report = sk.roll_window(self.state, self.cfg)
        elif self.mesh.sketch == 1:
            _, report, tables = self.roll_fn(self.state)
        else:
            shards = [sk.state_tables(s) for s in self.state.flat()]
            tables = None
            _, report = self.roll_fn(self.state)
        torch.cuda.synchronize()
        return tables, report, shards, time.perf_counter() - t0

    def close(self) -> None:
        self.ring.close()


def _mesh_windows(run, dense, n_folds: int, adds=None, touched=None):
    """WINDOWS windows of n_folds pool batches each through `run`; per
    window its batches, pre-roll tables, report, the per-cell adds of a
    plain run (`adds` and `touched` as `plain_versions` fills them) and
    the timings."""
    import torch
    out = []
    n = len(dense)
    for w in range(WINDOWS):
        if adds is not None:
            adds.clear()
            touched.clear()
        feed = [(w * n_folds + i) % n for i in range(n_folds)]
        torch.cuda.synchronize()
        run.device_ms.clear()
        t0 = time.perf_counter()
        for bi in feed:
            run.fold(dense[bi])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dev_ms = [a.elapsed_time(b) for a, b in run.device_ms]
        tables, report, shards, roll_s = run.roll()
        out.append({"feed": feed, "wall": wall, "device_ms": dev_ms,
                    "tables": tables, "shards": shards, "report": report,
                    "roll_s": roll_s,
                    "adds": ({k: v.cpu().numpy() for k, v in adds.items()}
                             if adds is not None else None)})
    return out


def _report_heavy(report):
    """The report's heavy words and validity as host arrays."""
    import numpy as np
    return (report.heavy.words.cpu().numpy().astype(np.uint32),
            report.heavy.valid.cpu().numpy())


def _mesh_ingest(specs, universe, pool, dense, devices, main_res) -> dict:
    """(a): the 4x1 and 2x2 meshes on the pool's dense batches, against one
    card's wide fold (4x1) and an eager plain replay (2x2)."""
    import numpy as np
    from netobserv_tpu_torch.parallel import mesh as pmesh
    from netobserv_tpu_torch.scenarios import traffic
    from netobserv_tpu_torch.sketch import state as sk
    cfg = sk.SketchConfig()
    m41 = pmesh.make_mesh(pmesh.MeshSpec(4, 1), devices)
    m22 = pmesh.make_mesh(pmesh.MeshSpec(2, 2), devices)
    out = {}
    launches = {}
    # one card's fold, plain, with its per-cell adds: the bounds' reference
    adds: dict = {}
    touched: dict = {}
    with plain_versions(specs, adds, touched):
        single = MeshDenseRun(cfg, None, capture=False)
        ref = _mesh_windows(single, dense, FOLDS_PER_WINDOW, adds, touched)
        single.close()
    runs = {}
    for name, mesh in (("4x1", m41), ("2x2", m22)):
        plain_calls: dict = {}
        with counting_plains(specs, plain_calls):
            run = MeshDenseRun(cfg, mesh, capture=True)
            captures0 = [c.captures for c in run.ring.captures]
            for s in specs:
                s["kernel"].launches = 0
            wins = _mesh_windows(run, dense, FOLDS_PER_WINDOW)
            launches[name] = {s["name"]: s["kernel"].launches for s in specs}
            check([c.captures for c in run.ring.captures] == captures0
                  == [1] * len(mesh.distinct()),
                  f"{name}: captures {captures0}")
            run.close()
        check(not plain_calls, f"{name}: plain versions ran on the card: "
              f"{plain_calls}")
        shard_folds = WINDOWS * FOLDS_PER_WINDOW * 4
        want = _mesh_want(specs, shard_folds, mesh.sketch)
        check(launches[name] == want, f"mesh {name} launches "
              f"{launches[name]}, want {want}")
        runs[name] = wins
    # 4x1: the merged tables against one card's plain fold, whole-window
    # bounds; the heavy table is the merge's, so its overlap is reported.
    # The window totals sum in another order on the mesh (four partials,
    # then the merge): each is held to the add-order bound of the
    # window's rows (the heavy-eviction count, last, is left out)
    cmp41 = [compare_tables(w["tables"], r["tables"], {
        **r["adds"], "scalars": np.full(len(r["tables"]["scalars"]) - 1,
                                        len(r["feed"]) * BATCH)},
        min_overlap=0.0) for w, r in zip(runs["4x1"], ref)]
    # 2x2: every shard against an eager plain replay of the same mesh
    adds22: dict = {}
    touched22: dict = {}
    with plain_versions(specs, adds22, touched22):
        prun = MeshDenseRun(cfg, m22, capture=False)
        pwins = _mesh_windows(prun, dense, FOLDS_PER_WINDOW, adds22,
                              touched22)
        prun.close()
    cmp22 = [[compare_tables(a, b, p["adds"]) for a, b in
              zip(w["shards"], p["shards"])]
             for w, p in zip(runs["2x2"], pwins)]
    recalls = {}
    for name, wins in runs.items():
        recalls[name] = [traffic.check_recall(*_report_heavy(w["report"]),
                                              w["feed"], universe, pool)
                         for w in wins]
        check(min(recalls[name]) >= 0.99,
              f"mesh {name} recall@100 {recalls[name]}")
        for w in wins:
            check(float(w["report"].total_records) == len(w["feed"]) * BATCH,
                  f"mesh {name} records {float(w['report'].total_records)}")
    # the integer copy: 4x1 merged tables equal one card's captured fold,
    # bit for bit (but the heavy table and its evictions)
    ints = [_integer_dense(d) for d in dense[:MESH_INT_FOLDS]]
    got = {}
    for name, mesh in (("single", None), ("4x1", m41)):
        run = MeshDenseRun(cfg, mesh, capture=True)
        for flat in ints:
            run.fold(flat)
        got[name] = run.roll()[0]
        run.close()
    diff = [k for k in _tables_equal(got["4x1"], got["single"])
            if not k.startswith("heavy")]
    check(diff in ([], ["scalars"]) and np.array_equal(
        got["4x1"]["scalars"][:-1], got["single"]["scalars"][:-1]),
        f"integer window: mesh tables {diff} differ from one card's")
    wide_wall = main_res["window_seconds"][-1] * 1e3 / FOLDS_PER_WINDOW
    for name, wins in runs.items():
        last = wins[-1]
        out[name] = {
            "wall_ms_per_16384": last["wall"] * 1e3 / FOLDS_PER_WINDOW,
            "device_ms_per_16384": float(np.median(last["device_ms"])),
            "device_ms_per_16384_mean": float(np.mean(last["device_ms"])),
            "roll_with_merge_ms": [w["roll_s"] * 1e3 for w in wins],
            "recall_at_100": recalls[name],
            "launches_per_dispatch": {
                k: v / (WINDOWS * FOLDS_PER_WINDOW)
                for k, v in launches[name].items() if v}}
    out["single_card_wide"] = {
        "wall_ms_per_16384_main_path": wide_wall,
        "plain_wall_ms_per_16384": ref[-1]["wall"] * 1e3
        / FOLDS_PER_WINDOW}
    out["4x1_vs_single_card_plain"] = cmp41
    out["2x2_vs_plain_replay"] = [
        {"max_rel_diff": max(c["max_rel_diff"] for c in row),
         "min_heavy_identity_overlap": min(c["heavy_identity_overlap"]
                                           for c in row)}
        for row in cmp22]
    out["integer_window_exact"] = True
    return out, launches


def _mesh_exporter(specs, events, devices) -> dict:
    """(b): `TorchSketchExporter(mesh_shape="4x1")` on the lanes path's
    evictions, against its plain replay; a checkpoint restored in place
    mid-run."""
    import tempfile
    import numpy as np
    import torch
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    from netobserv_tpu_torch.federation import delta as fdelta
    from netobserv_tpu_torch.parallel import merge as pmerge
    from netobserv_tpu_torch.sketch import state as sk
    from netobserv_tpu_torch.utils import retrace
    stream = LaneFeeder(events).stream
    cuts = _tenant_cuts(len(stream[0]), WINDOWS)
    ev_all, lanes_all = stream

    def feed(exp, cut):
        from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
        for lo, hi in cut:
            exp.export_evicted(EvictedFlows(
                ev_all[lo:hi], **{k: v[lo:hi] for k, v in lanes_all.items()}))

    def make(frames, **kw):
        exp = TorchSketchExporter(
            sk.SketchConfig(), batch_size=BATCH, devices=devices,
            mesh_shape="4x1", sink=_discard, delta_sink=frames.append,
            **LANES_KW, **kw)
        with exp._lock, exp._on_device():
            exp._ensure_ring()  # the ladder's captures, before the counts
        return exp

    ckdir = tempfile.mkdtemp(prefix="mesh-ck-")
    frames: list = []
    exp = make(frames, checkpoint_dir=ckdir, checkpoint_every=1)
    try:
        ring = exp.ring
        check(ring.n_shards == 4 and ring.lanes == 2
              and ring.ladder == (1, 2, 4), f"ring: {ring.n_shards} shards, "
              f"{ring.lanes} lanes, ladder {ring.ladder}")
        captures0 = [c.captures for c in exp.captures]
        check(captures0 == [1, 1, 1], f"ladder captures {captures0}")
        retraces0 = retrace.total_retraces()
        torch.cuda.synchronize()
        for s in specs:
            s["kernel"].launches = 0
        folds0 = exp.folds
        t0 = time.perf_counter()
        feed(exp, cuts[0])
        exp.flush()
        torch.cuda.synchronize()
        wall0 = time.perf_counter() - t0
        # window 0's post-roll checkpoint, restored in place over a state
        # zeroed as a crash would lose it (the graphs stay bound); the
        # dictionaries are untouched, so window 1 packs as the replay's
        with exp._lock, exp._on_device():
            saved = pmerge.dist_tables(exp.state)
            for t in _tensors(exp.state):
                t.zero_()
            exp._ckpt.restore(exp.state)
            back = pmerge.dist_tables(exp.state)
        check(all(np.array_equal(saved[k], back[k]) for k in saved),
              "the restored state differs from the saved one")
        t1 = time.perf_counter()
        feed(exp, cuts[1])
        exp.flush()
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t1
        launches = {s["name"]: s["kernel"].launches for s in specs}
        dispatches = exp.folds - folds0
        want = _mesh_want(specs, 4 * dispatches, 1)
        check(launches == want, f"mesh exporter launches {launches}, "
              f"want {want}")
        check([c.captures for c in exp.captures] == captures0
              and retrace.total_retraces() == retraces0,
              "a capture or retrace during the mesh exporter run")
        kt = key_table_check(ring)
        rows = sum(hi - lo for cut in cuts for lo, hi in cut)
        check(exp.records == rows, f"records {exp.records}, fed {rows}")
    finally:
        exp.close()
    # the plain replay: the same evictions, no restore
    pframes: list = []
    adds: dict = {}
    touched: dict = {}
    adds_by_window = []
    with plain_versions(specs, adds, touched):
        pexp = make(pframes, capture=False)
        try:
            for cut in cuts:
                adds.clear()
                touched.clear()
                feed(pexp, cut)
                pexp.flush()
                adds_by_window.append({k: v.cpu().numpy()
                                       for k, v in adds.items()})
        finally:
            pexp.close()
    got = [fdelta.decode_frame(f) for f in frames[:WINDOWS]]
    ref = [fdelta.decode_frame(f) for f in pframes[:WINDOWS]]
    cmp = [compare_tables(a.tables, b.tables, adds_by_window[w])
           for w, (a, b) in enumerate(zip(got, ref))]
    return {"records_per_s": [sum(hi - lo for lo, hi in cuts[0]) / wall0,
                              sum(hi - lo for lo, hi in cuts[1]) / wall1],
            "dispatches": dispatches, "lanes": 2, "shards": 4,
            "key_table_check": kt, "vs_plain": cmp,
            "checkpoint_restored_in_place": True}, launches


def _mesh_aggregator(specs, events, devices) -> dict:
    """(c): a 4x1 `FederationAggregator` over 4 lanes-path agents' frames
    of the integer-mass stream, 2 windows, against one card's aggregator
    over the same frames."""
    import numpy as np
    import torch
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    from netobserv_tpu_torch.federation.aggregator import (
        FederationAggregator,
    )
    from netobserv_tpu_torch.sketch import state as sk
    cfg = sk.SketchConfig()
    # the aggregators first, their graphs captured before any agent's ring
    aggs = {name: FederationAggregator(
        cfg, window_s=3600.0, sink=_discard,
        **({"mesh_shape": "4x1", "devices": devices} if name == "mesh"
           else {})) for name in ("mesh", "single")}
    ev, lanes = _integer_stream(events)
    owner = np.random.default_rng(13).integers(0, FED_AGENTS, len(ev))
    frames: list = [[] for _ in range(WINDOWS)]
    launches = {}
    agents = []
    try:
        for a in range(FED_AGENTS):
            sink: list = []
            exp = TorchSketchExporter(
                cfg, batch_size=BATCH, sink=_discard, agent_id=f"agent-{a}",
                delta_sink=sink.append, **LANES_KW)
            with exp._lock, exp._on_device():
                exp._ensure_ring()
            agents.append((exp, sink))
        torch.cuda.synchronize()
        for s in specs:
            s["kernel"].launches = 0
        folds = 0
        rng = np.random.default_rng(4)
        for w in range(WINDOWS):
            for a, (exp, sink) in enumerate(agents):
                mine = np.flatnonzero(owner == a)
                half = mine[w * len(mine) // WINDOWS:
                            (w + 1) * len(mine) // WINDOWS]
                f0 = exp.folds
                _evict(exp, (ev[half], {k: v[half]
                                        for k, v in lanes.items()}), rng)
                exp.flush()
                folds += exp.folds - f0
                frames[w].append(sink[-1])
        launches = {s["name"]: s["kernel"].launches for s in specs}
        want = _want_launches(specs, "lanes", folds)
        check(launches == want, f"agents' launches {launches}, want {want}")
        snaps = {n: [] for n in aggs}
        ingest_ms = {n: [] for n in aggs}
        flush_ms = {n: [] for n in aggs}
        for w in range(WINDOWS):
            for name, agg in aggs.items():
                for f in frames[w]:
                    t0 = time.perf_counter()
                    ack = agg.ingest_frame(f)
                    ingest_ms[name].append((time.perf_counter() - t0) * 1e3)
                    check(ack.accepted == 1, f"{name} refused a frame")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                agg.flush()
                flush_ms[name].append((time.perf_counter() - t0) * 1e3)
                snaps[name].append(agg.snapshot())
        check(aggs["mesh"].status()["mesh"] is True, "mesh status")
        overlap = []
        for a, b in zip(snaps["mesh"], snaps["single"]):
            for k in ("cm_bytes", "cm_pkts"):
                check(np.array_equal(a[k], b[k]), f"cluster {k} differs")
            for k in ("total_records", "total_bytes", "window"):
                check(a[k] == b[k], f"cluster {k} {a[k]} != {b[k]}")
            ids = [{(int(x), int(y)) for x, y, v in zip(
                s["heavy"]["h1"], s["heavy"]["h2"], s["heavy"]["valid"])
                if v} for s in (a, b)]
            overlap.append(len(ids[0] & ids[1]) / max(1, len(ids[0]
                                                            | ids[1])))
    finally:
        for exp, _ in agents:
            exp.close()
        for agg in aggs.values():
            agg.close()
    return {"agents": FED_AGENTS, "windows": WINDOWS,
            "frames": sum(len(f) for f in frames),
            "cluster_cm_exact": True,
            "heavy_identity_overlap_vs_single_card": overlap,
            "ingest_frame_ms_p50": {n: _pct(v, 50)
                                    for n, v in ingest_ms.items()},
            "flush_ms": flush_ms}, launches


def phase_mesh(specs, universe, pool, dense, events, main_res,
               card: str) -> dict:
    """The mesh on the card (module docstring, `mesh`)."""
    import torch
    t_phase = time.perf_counter()
    devices = mesh_devices()
    ingest, launches = _mesh_ingest(specs, universe, pool, dense, devices,
                                    main_res)
    exp_res, exp_launches = _mesh_exporter(specs, events, devices)
    agg_res, agg_launches = _mesh_aggregator(specs, events, devices)
    # fault C14: the record path on a 4x1 and a 1x2 mesh
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    from netobserv_tpu_torch.parallel import merge as pmerge
    from netobserv_tpu_torch.sketch import state as sk
    records = {}
    for shape in ("4x1", "1x2"):
        n = 4 if shape == "4x1" else 2
        records[shape] = _record_path(
            specs, events,
            lambda where, _s=shape, _n=n: TorchSketchExporter(
                sk.SketchConfig(), batch_size=BATCH, mesh_shape=_s,
                devices=(devices[:_n] if where == "card"
                         else ["cpu"] * _n), sink=_discard),
            lambda exp: pmerge.dist_tables(exp.state))
    return {"phase": "mesh", "card": card,
            "device_count": torch.cuda.device_count(), "devices": devices,
            "ingest": ingest, "exporter": exp_res, "aggregator": agg_res,
            "record_path": records,
            "launches": {"mesh_4x1": launches["4x1"],
                         "mesh_2x2": launches["2x2"],
                         "mesh_exporter": exp_launches,
                         "mesh_aggregator": agg_launches},
            "seconds": time.perf_counter() - t_phase}


#: the distributed phase: its two ranks' time limit, in seconds (both
#: within it), and the exporter's batches a window (pool batches of BATCH
#: rows)
DIST_TIMEOUT_S = 120
DIST_EXP_BATCHES = 8


def dist_topology() -> tuple[str, list]:
    """(backend, each rank's device) of the distributed phase: NCCL with
    rank r on cuda:r where there are two cards or more, else gloo with
    both ranks on cuda:0 (NCCL refuses two ranks on one device)."""
    import torch
    if torch.cuda.device_count() >= 2:
        return "nccl", ["cuda:0", "cuda:1"]
    return "gloo", ["cuda:0", "cuda:0"]


def _dist_ingest(specs, dense, mesh, cfg, pool, universe) -> dict:
    """(a) in one rank: the pool's dense batches into a `DenseStagingRing`
    on the 2x1 mesh that spans the ranks, WINDOWS windows of
    FOLDS_PER_WINDOW dispatches, each closed by the merge across ranks
    (its stats kept); then an integer copy of MESH_INT_FOLDS batches."""
    import numpy as np
    import torch
    from netobserv_tpu_torch.scenarios import traffic
    plain_calls: dict = {}
    with counting_plains(specs, plain_calls):
        run = MeshDenseRun(cfg, mesh, capture=True)
        for s in specs:
            s["kernel"].launches = 0
        wins = []
        for w in range(WINDOWS):
            feed = [(w * FOLDS_PER_WINDOW + i) % len(dense)
                    for i in range(FOLDS_PER_WINDOW)]
            torch.cuda.synchronize()
            run.device_ms.clear()
            t0 = time.perf_counter()
            for bi in feed:
                run.fold(dense[bi])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            dev_ms = [a.elapsed_time(b) for a, b in run.device_ms]
            run.roll_fn.stats = stats = {}
            tables, report, _, roll_s = run.roll()
            run.roll_fn.stats = None
            words, valid = _report_heavy(report)
            wins.append({
                "feed": feed, "wall_ms_per_16384":
                    wall * 1e3 / FOLDS_PER_WINDOW,
                "device_ms_per_16384": float(np.median(dev_ms)),
                "roll_ms": roll_s * 1e3, "merge": stats,
                "records": float(report.total_records),
                "recall_at_100": traffic.check_recall(
                    words, valid, feed, universe, pool),
                "tables": tables,
                "heavy": (words, valid)})
        launches = {s["name"]: s["kernel"].launches for s in specs}
        run.close()
        ints = MeshDenseRun(cfg, mesh, capture=True)
        for flat in dense[:MESH_INT_FOLDS]:
            ints.fold(_integer_dense(flat))
        int_tables = ints.roll()[0]
        ints.close()
    check(not plain_calls, f"plain versions ran on the card: {plain_calls}")
    return {"windows": wins, "launches": launches, "integer": int_tables}


def _dist_exporter(events, device: str) -> dict:
    """(b) in one rank: `TorchSketchExporter(mesh_shape="2")` on the dense
    feed over the ranks, WINDOWS windows of DIST_EXP_BATCHES pool batches,
    each closed by `roll()`; its reports without their publish times."""
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    from netobserv_tpu_torch.sketch import state as sk
    reports: list = []
    t0 = time.perf_counter()
    exp = TorchSketchExporter(sk.SketchConfig(), batch_size=BATCH,
                              mesh_shape="2", devices=[device], feed="dense",
                              sink=reports.append)
    try:
        check(exp.mesh.multiprocess and exp.ring is not None,
              "the exporter's mesh does not span the ranks")
        for w in range(WINDOWS):
            for i in range(DIST_EXP_BATCHES):
                ev, f = events[(w * DIST_EXP_BATCHES + i) % len(events)]
                exp.fold_events(ev, **f)
            exp.roll()
    finally:
        exp.close()
    return {"reports": [{k: v for k, v in r.items() if k != "TimestampMs"}
                        for r in reports],
            "folds": exp.folds, "seconds": time.perf_counter() - t0}


def dist_child_main(argv) -> int:
    """`chip_smoke.py --dist-rank R PORT BACKEND DEVICE OUT`: one rank of
    the distributed phase. It joins the two-rank group at 127.0.0.1:PORT
    with BACKEND on DEVICE, runs (a) and (b) on the kernels the parent
    built and writes its results to OUT/rank<R>.pkl."""
    import os
    import pickle
    rank, port, backend, device, out = (int(argv[0]), argv[1], argv[2],
                                        argv[3], argv[4])
    os.environ.update(SKETCH_COORDINATOR=f"127.0.0.1:{port}",
                      SKETCH_NUM_PROCESSES="2", SKETCH_PROCESS_ID=str(rank))
    import numpy as np
    import torch
    from netobserv_tpu_torch.ops.kernels import _build
    from netobserv_tpu_torch.parallel import distributed
    from netobserv_tpu_torch.parallel import mesh as pmesh
    from netobserv_tpu_torch.scenarios import traffic
    from netobserv_tpu_torch.sketch import state as sk
    torch.cuda.set_device(device)
    t0 = time.perf_counter()
    check(distributed.maybe_initialize_distributed(backend=backend,
                                                   devices=[device]),
          "no process group")
    init_s = time.perf_counter() - t0
    specs = kernel_specs()
    _build.load_all()
    universe, pool = traffic.make_pool(np.random.default_rng(0))
    dense = traffic.dense_pool(pool)
    events = traffic.event_pool(pool, np.random.default_rng(0))
    mesh = pmesh.make_mesh(pmesh.MeshSpec(2, 1), [device])
    check(mesh.ranks == ((0,), (1,)) and mesh.addressable() == [(rank, 0)],
          f"mesh cells {mesh.ranks}")
    res = _dist_ingest(specs, dense, mesh, sk.SketchConfig(), pool,
                       universe)
    res["exporter"] = _dist_exporter(events, device)
    res.update(rank=rank, backend=distributed.backend(),
               world=distributed.process_count(), init_s=init_s,
               device=device)
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(res, fh)
    distributed.destroy()
    print(f"DIST_CHILD_OK rank={rank}", flush=True)
    return 0


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _dist_children(backend: str, devices: list, out: str) -> list:
    """Run the two ranks (`--dist-rank`) to their end; a rank that fails
    or outlives DIST_TIMEOUT_S fails the phase, and every rank left is
    killed."""
    import os
    import pickle
    port = _free_port()
    procs, logs = [], [os.path.join(out, f"rank{r}.log") for r in range(2)]
    for r in range(2):
        with open(logs[r], "w") as log:  # a file: no pipe fills up
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dist-rank",
                 str(r), str(port), backend, devices[r], out],
                stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + DIST_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        check(False, f"a rank outlived {DIST_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        with open(logs[r]) as fh:
            log = fh.read()
        check(p.returncode == 0 and "DIST_CHILD_OK" in log,
              f"rank {r} failed (rc {p.returncode}):\n{log[-4000:]}")
    out_ranks = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as fh:
            out_ranks.append(pickle.load(fh))
    return out_ranks


def phase_distributed(specs, universe, pool, dense, card: str) -> dict:
    """The mesh over two processes (module docstring, `distributed`): two
    ranks of this script, each one data shard of a 2x1 mesh that spans
    them; (a) their merged reports and tables against each other and
    against a one-process 2x1 mesh's replay of the same batches, (b) the
    exporter's reports against each other."""
    import tempfile
    import numpy as np
    from netobserv_tpu_torch.parallel import mesh as pmesh
    from netobserv_tpu_torch.sketch import state as sk
    t_phase = time.perf_counter()
    backend, devices = dist_topology()
    emit({"phase": "distributed_topology", "backend": backend,
          "world": 2, "devices": devices, "card": card})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as out:
        ranks = _dist_children(backend, devices, out)
    t_children = time.perf_counter() - t_phase
    for r in ranks:
        check(r["backend"] == backend and r["world"] == 2,
              f"rank {r['rank']}: {r['backend']} x {r['world']}")
    a, b = ranks
    # both ranks' merged reports and tables, bit for bit
    for w, (wa, wb) in enumerate(zip(a["windows"], b["windows"])):
        check(not _tables_equal(wa["tables"], wb["tables"])
              and all(np.array_equal(x, y) for x, y in
                      zip(wa["heavy"], wb["heavy"]))
              and wa["records"] == wb["records"],
              f"window {w}: the ranks' merged tables differ")
    check(not _tables_equal(a["integer"], b["integer"]),
          "integer window: the ranks' merged tables differ")
    check(a["exporter"]["reports"] == b["exporter"]["reports"],
          "the exporter's reports differ between the ranks")
    # a one-process 2x1 mesh's replay of the same batches: plain (for the
    # whole-window bounds) and, on the integer copy, captured, bit for bit
    cfg = sk.SketchConfig()
    one = pmesh.make_mesh(pmesh.MeshSpec(2, 1), [devices[0]] * 2)
    adds: dict = {}
    touched: dict = {}
    cmp = []
    with plain_versions(specs, adds, touched):
        prun = MeshDenseRun(cfg, one, capture=False)
        for w, win in enumerate(a["windows"]):
            adds.clear()
            touched.clear()
            for bi in win["feed"]:
                prun.fold(dense[bi])
            tables = prun.roll()[0]
            cmp.append(compare_tables(win["tables"], tables, {
                **{k: v.cpu().numpy() for k, v in adds.items()},
                "scalars": np.full(len(tables["scalars"]) - 1,
                                   len(win["feed"]) * BATCH)}))
        prun.close()
    ints = MeshDenseRun(cfg, one, capture=True)
    for flat in dense[:MESH_INT_FOLDS]:
        ints.fold(_integer_dense(flat))
    want_int = ints.roll()[0]
    ints.close()
    diff = _tables_equal(a["integer"], want_int)
    check(not diff, f"integer window: tables {diff} differ from one "
          "process's 2x1 mesh")
    recalls = [w["recall_at_100"] for w in a["windows"]]
    check(min(recalls) >= 0.99, f"recall@100 {recalls}")
    for w in a["windows"]:
        check(w["records"] == len(w["feed"]) * BATCH,
              f"records {w['records']}")
    want = _mesh_want(specs, WINDOWS * FOLDS_PER_WINDOW, 1)
    for r in ranks:
        check(r["launches"] == want, f"rank {r['rank']} launches "
              f"{r['launches']}, want {want}")
    exp_records = [rep["Records"] for rep in a["exporter"]["reports"]]
    check(exp_records[:WINDOWS] == [float(DIST_EXP_BATCHES * BATCH)]
          * WINDOWS, f"exporter records {exp_records}")
    folds = WINDOWS * FOLDS_PER_WINDOW
    per_rank = [{
        "rank": r["rank"], "device": r["device"], "init_s": r["init_s"],
        "wall_ms_per_16384": r["windows"][-1]["wall_ms_per_16384"],
        "device_ms_per_16384": r["windows"][-1]["device_ms_per_16384"],
        "roll_ms": [w["roll_ms"] for w in r["windows"]],
        "merge_local_ms": [w["merge"]["local_ms"] for w in r["windows"]],
        "merge_cross_ms": [w["merge"]["cross_ms"] for w in r["windows"]],
        "merge_select_ms": [w["merge"]["select_ms"] for w in r["windows"]],
        "reduce_bytes": r["windows"][-1]["merge"]["reduce_bytes"],
        "gather_bytes": r["windows"][-1]["merge"]["gather_bytes"],
        "launches_per_dispatch": {k: v / folds for k, v in
                                  r["launches"].items() if v},
        "exporter_seconds": r["exporter"]["seconds"]} for r in ranks]
    return {"phase": "distributed", "card": card, "backend": backend,
            "world": 2, "devices": devices, "ranks": per_rank,
            "recall_at_100": recalls,
            "vs_one_process_plain": cmp, "integer_window_exact": True,
            "exporter_windows": len(a["exporter"]["reports"]),
            "children_seconds": t_children,
            "launches": {k: a["launches"][k] + b["launches"][k]
                         for k in a["launches"]},
            "seconds": time.perf_counter() - t_phase}


def phase_dense_ring(specs) -> dict:
    """The dense and compact rings at full width, fed flow events of a v4
    pool (v4-mapped keys, V6_SHARES of v6 rows a batch; the last batch a
    burst past the compact feed's spill lane, so its dense fallback runs):
    each feed captured, eager and plain, 2 windows x 32 batches."""
    import numpy as np
    from netobserv_tpu_torch.datapath import flowpack
    from netobserv_tpu_torch.scenarios import traffic
    from netobserv_tpu_torch.sketch import staging
    from netobserv_tpu_torch.sketch import state as sk
    cfg = sk.SketchConfig()
    universe, pool = traffic.make_pool(np.random.default_rng(2), v4=True,
                                       v6_share=V6_SHARES)
    events = traffic.event_pool(pool, np.random.default_rng(3))
    out = {"phase": "dense_ring", "v6_share_per_batch": list(V6_SHARES),
           "feeds": {}}
    records = WINDOWS * FOLDS_PER_WINDOW * BATCH
    for feed, path in (("dense", "dense_ring"), ("compact", "compact_ring")):
        runs = _runs(event_feeder(events), len(events), specs, cfg,
                     ring=True, exp_kw={"feed": feed, **LANES_KW})
        run, eager, plain = (runs[m] for m in MODES)
        ring = run["ring"]
        check(isinstance(ring, staging.DenseStagingRing)
              and (ring.spill_cap is not None) == (feed == "compact"),
              f"{feed}: ring {ring}")
        check(run["folds"] == WINDOWS * FOLDS_PER_WINDOW,
              f"{feed}: {run['folds']} dispatches")
        _check_launches(runs, specs, path, run["folds"], feed)
        if feed == "compact":
            check(ring.dense_fallbacks >= 1, "no dense fallback")
            for other in (eager, plain):
                check(other["ring"].dense_fallbacks == ring.dense_fallbacks,
                      "the eager or plain run fell back otherwise")
            fb = ring.dense_fallbacks
            _check_watch(run, {"fold_compact": run["folds"] - fb,
                               "fold_compact_dense": fb})
            h2d = ((run["folds"] - fb)
                   * flowpack.compact_buf_len(BATCH, ring.spill_cap) * 4
                   + fb * BATCH * sk.DENSE_WORDS * 4)
        else:
            _check_watch(run, {"fold_dense_ring": run["folds"]})
            h2d = run["folds"] * BATCH * sk.DENSE_WORDS * 4
        recalls = _check_windows(run["windows"],
                                 traffic.event_universe(universe), pool)
        cmp, cmp_eager = _compare_runs(runs)
        res = {"recall_at_100": recalls,
               **_window_summary(runs, cmp, cmp_eager),
               **_ring_summary(run, eager, plain, {
                   "pack_threads": ring.pack_threads,
                   "spill_cap": ring.spill_cap}),
               "dense_fallbacks": ring.dense_fallbacks,
               "h2d_bytes_per_record": h2d / records}
        out["feeds"][feed] = res
        out[path] = res["launches"]
    return out


def _c1_run(specs, dense, cfg, mode: str) -> dict:
    """C1_FOLDS pool batches through the dense feed under `cfg`, folded as
    `mode` says (MODES): the kernel runs count every call of a plain
    version (there must be none), the plain run the adds of the window
    bounds; the launch counts are set to 0 just before and read just
    after."""
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    adds: dict = {}
    touched: dict = {}
    plain_calls: dict = {}
    ctx = (plain_versions(specs, adds, touched) if mode == "plain"
           else counting_plains(specs, plain_calls))
    with ctx:
        exp = TorchSketchExporter(cfg, batch_size=BATCH, device="cuda",
                                  sink=_discard, capture=mode == "captured")
        for s in specs:
            s["kernel"].launches = 0
        win = _window(exp, dense_feeder(dense), len(dense), 0, C1_FOLDS,
                      adds, touched)
        win["launches"] = {s["name"]: s["kernel"].launches for s in specs}
        win["watch"] = _watch_stats(exp)
        exp.close()
    check(not plain_calls, f"plain versions ran on the card: {plain_calls}")
    return win


def phase_c1(specs, dense) -> dict:
    """Fault C1's two shapes on the card: a depth whose kernel-6 tile
    passes one block's shared memory, which the gate sends to the decode
    form (the wide path's kernels), and a table width past what kernel 7's
    first design held, which folds on the interior form through kernel 7;
    and a depth whose kernel-6 tile needs the shared-memory attribute set
    at launch, inside the capture too (interior form).
    Each runs captured, eager and plain: the captured run's tables are held
    against both under the whole-window bounds (the tiered CM tables under
    the tier bound), the packed HLL banks bit-exact."""
    from netobserv_tpu_torch.sketch import state as sk
    from netobserv_tpu_torch.sketch.tiered import TierSpec
    out = {"phase": "c1_shapes", "folds": C1_FOLDS, "shapes": []}
    for cfg, form, path in (
            (sk.SketchConfig(cm_depth=25, tiered=TierSpec()), "decode",
             "wide"),
            (sk.SketchConfig(ewma_buckets=16384, tiered=TierSpec()),
             "interior", "tiered"),
            (sk.SketchConfig(cm_depth=6, tiered=TierSpec()), "interior",
             "tiered")):
        got = sk.tiered_fold_form(cfg)
        check(got == form, f"{cfg}: fold form {got}, want {form}")
        runs = {m: _c1_run(specs, dense, cfg, m) for m in MODES}
        run, eager, plain = (runs[m] for m in MODES)
        _check_launches(runs, specs, path, C1_FOLDS, f"{form} form")
        _check_watch(run, {"fold_dense": C1_FOLDS})
        for other in (eager, plain):
            check(all(_exact(x, y) for x, y in zip(
                _tensors(run["tiers"][2:]), _tensors(other["tiers"][2:]))),
                f"{form} form: the packed HLL banks differ")
        cmp = compare_tables(run["tables"], plain["tables"], plain["adds"],
                             _tier_checker(run, plain, cfg.tiered))
        cmp_eager = compare_tables(run["tables"], eager["tables"],
                                   plain["adds"],
                                   _tier_checker(run, eager, cfg.tiered,
                                                 plain))
        out["shapes"].append({
            "cm_depth": cfg.cm_depth, "ewma_buckets": cfg.ewma_buckets,
            "form": got, "launches": run["launches"], "vs_plain": cmp,
            "vs_eager": cmp_eager, "seconds": run["seconds"],
            "eager_seconds": eager["seconds"],
            "plain_seconds": plain["seconds"]})
    return out


def _traced(specs, rows) -> dict:
    """Per kernel `__global__` (the first of its `trace` names), the kernel
    events a trace counts under it."""
    return {s["trace"][0]: sum(c for _, k, c in rows
                               if any(t in k for t in s["trace"]))
            for s in specs}


def _traced_want(specs, launches: dict) -> dict:
    """The kernel events `launches` make: one per launch, the HLL entries
    (one `__global__`) summed."""
    want: dict = {}
    for s in specs:
        key = s["trace"][0]
        want[key] = want.get(key, 0) + launches[s["name"]]
    return want


def phase_profile(specs, feed, n_batches: int, cfg, name: str, path: str,
                  capture: bool, warm: int = 2, exp_kw: dict | None = None,
                  batches_per_call: int = 1) -> dict:
    """Device time by kernel over FOLDS_PER_WINDOW // 4 calls of a path's
    feed (torch.profiler) after `warm` warm-up calls, captured or eager,
    and the device's busy share of the wall time; each call folds
    `batches_per_call` batches of BATCH records, and the times are per
    batch ("per_fold", per 16,384 records). The trace must count each
    kernel of the path as often as the launch counts say (a replay adds
    its capture's launches), and the launch counts must be the path's per
    ingest dispatch, or the loop runs again, up to PROFILE_TRIES times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    exp = TorchSketchExporter(cfg, batch_size=BATCH, device="cuda",
                              sink=_discard, capture=capture,
                              **(exp_kw or {}))
    for i in range(warm):
        feed(exp, i % n_batches)
    torch.cuda.synchronize()
    n = FOLDS_PER_WINDOW // 4
    for _ in range(PROFILE_TRIES):
        for s in specs:
            s["kernel"].launches = 0
        folds0, pack0 = exp.folds, _pack_seconds(exp)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(n):
                feed(exp, i % n_batches)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        chunks = exp.folds - folds0
        launches = {s["name"]: s["kernel"].launches for s in specs}
        rows = _device_rows(prof)
        if rows and _traced(specs, rows) == _traced_want(specs, launches):
            break
        PROFILE_RETRIED.append(1)
    else:
        raise PhaseError(f"{name}: no trace in {PROFILE_TRIES} counted the "
                         f"launches {launches}: {_traced(specs, rows)}")
    want = _want_launches(specs, path, chunks)
    check(launches == want, f"{name}: launches {launches}, want {want}")
    pack = _pack_seconds(exp) - pack0
    _watch_stats(exp)
    exp.close()
    busy_us = sum(r[0] for r in rows)
    check(busy_us > 0, "the profiler saw no device time")
    nb = n * batches_per_call  # batches of BATCH records folded
    return {"phase": name, "path": path, "captured": capture, "calls": n,
            "batches_per_call": batches_per_call, "folds": nb,
            "ingest_calls": chunks, "launches": launches,
            "wall_ms_per_fold": wall * 1e3 / nb,
            "device_ms_per_fold": busy_us / 1e3 / nb,
            "device_busy_share": busy_us / 1e6 / wall if wall else None,
            "pack_seconds_per_fold": pack / nb,
            "top_device_ops": [{"name": k[:80], "us_per_fold": us / nb,
                                "calls_per_fold": c / nb}
                               for us, k, c in rows[:15]]}


def phase_watch() -> dict:
    """The compile watch over the run: every captured fold of every
    captured exporter captured once, at its first call (a ladder entry
    when its ring was made), and never again (a graph whose feed was not
    folded, never, but for a ladder entry); no retrace in the process.
    `snapshot` is the watch's snapshot of each captured exporter, taken
    while it lived (`_watch_stats`)."""
    from netobserv_tpu_torch.utils import retrace
    total = retrace.total_retraces()
    check(total == 0, f"{total} retraces")
    check(WATCHED and all(
        w["compiles"] == (1 if _warm_captured(w["fn"])
                          else min(w["calls"], 1))
        and w["retraces"] == 0 for w in WATCHED),
        f"captured folds {WATCHED}")
    used = [w for w in WATCHED if w["calls"]]
    return {"phase": "retrace_watch", "total_retraces": total,
            "captured_folds": len(used),
            "captures": sum(w["compiles"] for w in WATCHED),
            "replays": sum(w["calls"] for w in WATCHED),
            "capture_seconds": [w["compile_seconds"] for w in used],
            "snapshot": [{k: v for k, v in w.items()
                          if k != "last_signature"} for w in WATCHED],
            "signatures": {w["fn"]: w.get("last_signature", "")
                           for w in used}}


#: profile phases: (path, name, feed kind, warm-up calls: None = the
#: pool, exporter arguments, batches a call)
PROFILES = (("wide", "profile", "dense", 2, None, 1),
            ("tiered", "profile_tiered", "dense", 2, None, 1),
            ("resident", "profile_resident", "events", None, RESIDENT_KW, 1),
            ("lanes", "profile_lanes", "superbatch", 2, LANES_KW, 4))


def phase_profiles(specs, dense, events, paths: dict) -> dict:
    """The profile phases, each path captured then eager; emits each and
    returns the `per_fold` line: per path and batch of 16,384 records, the
    profiled wall and device ms, busy share and pack seconds, and from
    the path phase's unprofiled windows (`paths`, by path) the wall ms
    (of the last reset window, steady state: a captured run's first
    window holds its capture) and the device ms over it. The lanes path
    is profiled at k = 4 (each call one eviction of 4 batches, one
    superbatch dispatch); its window is the lanes phase's eviction mix."""
    from netobserv_tpu_torch.sketch import state as sk
    cfgs = {"wide": sk.SketchConfig(), "tiered": tiered_cfg(),
            "resident": sk.SketchConfig(), "lanes": sk.SketchConfig()}
    out = {"phase": "per_fold"}
    for path, name, kind, warm, kw, per_call in PROFILES:
        if kind == "dense":
            pool, feeder = dense, dense_feeder(dense)
        elif kind == "events":
            pool, feeder = events, event_feeder(events)
        else:
            feeder = SuperbatchFeeder(events, per_call)
            pool = feeder.parts
        out[path] = {}
        for capture in (True, False):
            r = phase_profile(specs, feeder, len(pool), cfgs[path],
                              name + ("" if capture else "_eager"), path,
                              capture, len(pool) if warm is None else warm,
                              kw, per_call)
            emit(r)
            secs = paths[path]["window_seconds" if capture
                               else "eager_window_seconds"]
            window_ms = secs[-1] * 1e3 / FOLDS_PER_WINDOW
            out[path]["captured" if capture else "eager"] = {
                **{k: r[k] for k in ("wall_ms_per_fold", "device_ms_per_fold",
                                     "device_busy_share",
                                     "pack_seconds_per_fold")},
                "window_wall_ms_per_fold": window_ms,
                "device_over_window_wall": r["device_ms_per_fold"]
                / window_ms}
    return out


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    try:
        import numpy as np
        from netobserv_tpu_torch.scenarios import traffic
        from netobserv_tpu_torch.sketch import state as sk
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = "device"
    t_start = time.perf_counter()
    try:
        dev = phase_device()
        emit(dev)
        specs = kernel_specs()
        phase = "build"
        emit(phase_build(specs))
        phase = "traffic"
        t0 = time.perf_counter()
        universe, pool = traffic.make_pool(np.random.default_rng(0))
        dense = traffic.dense_pool(pool)
        events = traffic.event_pool(pool, np.random.default_rng(0))
        emit({"phase": "traffic", "seconds": time.perf_counter() - t0,
              "batches": len(pool), "rows_per_batch": BATCH})
        phase = "native_pack"
        emit(phase_native_pack(events))
        phase = "kernels"
        calls = {"wide": capture_main_path_inputs(specs, dense,
                                                  sk.SketchConfig()),
                 "tiered": capture_main_path_inputs(specs, dense,
                                                    tiered_cfg())}
        results = phase_kernels(specs, calls)
        phase = "main_path"
        main_res = phase_main_path(specs, universe, pool, dense)
        emit(main_res)
        phase = "tiered_path"
        tier_res = phase_tiered_path(specs, universe, pool, dense)
        wide_b = sum(main_res["resident_bytes"].values())
        tier_b = sum(tier_res["resident_bytes"].values())
        tier_res["resident_bytes_wide_over_tiered"] = wide_b / tier_b
        emit(tier_res)
        phase = "resident_path"
        res_res = phase_resident_path(specs, universe, pool, events)
        emit(res_res)
        phase = "lanes_path"
        lanes_res = phase_lanes_path(specs, universe, pool, events)
        emit(lanes_res)
        phase = "fused_drain"
        fd_res = phase_fused_drain(specs, events, dev["nvidia_smi"])
        emit(fd_res)
        phase = "kernel_datapath"
        kd_res = phase_kernel_datapath(specs, events, dev["nvidia_smi"],
                                       fd_res["fused"])
        emit(kd_res)
        phase = "window_thread"
        wt_res = phase_window_thread(specs, universe, pool, events)
        emit(wt_res)
        phase = "query_plane"
        qp_res = phase_query_plane(specs, universe, pool, events,
                                   wt_res["records_per_s"])
        emit(qp_res)
        phase = "federation"
        fed_res = phase_federation(specs, universe, pool, events,
                                   wt_res["records_per_s"])
        emit(fed_res)
        phase = "exporters"
        ex_res = phase_exporters(specs, events)
        emit(ex_res)
        phase = "flp_pca"
        flp_res = phase_flp_pca(specs)
        emit(flp_res)
        phase = "archive"
        arc_res = phase_archive(specs, universe, pool, events)
        emit(arc_res)
        phase = "overload"
        ov_res = phase_overload(specs, universe, pool, events,
                                dev["nvidia_smi"])
        emit(ov_res)
        phase = "agent_entry"
        ae_res = phase_agent_entry(specs, events,
                                   _lanes_rate(lanes_res),
                                   wt_res["records_per_s"], dev["nvidia_smi"])
        emit(ae_res)
        phase = "ifaces_features"
        if_res = phase_ifaces_features(specs, dev["nvidia_smi"])
        emit(if_res)
        phase = "scenarios"
        zoo_res = phase_scenarios(specs, dev["nvidia_smi"])
        emit(zoo_res)
        phase = "ringbuf"
        rb_res = phase_ringbuf(specs, dev["nvidia_smi"])
        emit(rb_res)
        phase = "tenants"
        tn_res = phase_tenants(specs, events, dev["nvidia_smi"])
        emit(tn_res)
        phase = "mesh"
        mesh_res = phase_mesh(specs, universe, pool, dense, events,
                              main_res, dev["nvidia_smi"])
        emit(mesh_res)
        phase = "distributed"
        dist_res = phase_distributed(specs, universe, pool, dense,
                                     dev["nvidia_smi"])
        emit(dist_res)
        phase = "dense_ring"
        ring_res = phase_dense_ring(specs)
        emit(ring_res)
        phase = "c1_shapes"
        emit(phase_c1(specs, dense))
        phase = "profile"
        emit(phase_profiles(specs, dense, events, {
            "wide": main_res, "tiered": tier_res, "resident": res_res,
            "lanes": lanes_res}))
        phase = "retrace_watch"
        emit(phase_watch())
        torch.cuda.synchronize()
    except Exception as e:  # every phase failure ends the run, loudly
        import traceback
        traceback.print_exc()
        emit({"phase": phase, "ok": False,
              "error": f"{type(e).__name__}: {e}"})
        return 1
    launches = {"wide": main_res["launches"], "tiered": tier_res["launches"],
                "resident": res_res["launches"],
                "lanes": lanes_res["launches"],
                "fused_drain": fd_res["launches"],
                "fused_drain_raw": fd_res["raw_launches"],
                # the real maps' runs, where this machine allows bpf(2)
                **({"kernel_datapath": kd_res["launches"],
                    "kernel_datapath_raw": kd_res["raw_launches"]}
                   if "launches" in kd_res else {}),
                "window_thread": wt_res["launches"],
                "query_plane": qp_res["launches"],
                "federation": fed_res["launches"],
                "exporters": ex_res["launches"],
                "flp_pca": flp_res["launches"],
                "archive": arc_res["launches"],
                "overload": ov_res["launches"],
                "agent_entry": ae_res["launches"],
                "ifaces_features": if_res["launches"],
                "scenarios": zoo_res["launches"],
                "ringbuf": rb_res["launches"],
                "tenants": tn_res["launches"],
                "tenants_tiered": tn_res["tiered_launches"],
                **mesh_res["launches"],
                "distributed": dist_res["launches"],
                "dense_ring": ring_res["dense_ring"],
                "compact_ring": ring_res["compact_ring"]}
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "traces_retried": len(PROFILE_RETRIED)})
    emit({"kernels": [
        {"name": r["name"], "route": "cuda",
         "source": f"netobserv_tpu_torch/csrc/{s['kernel'].source}",
         "replaces": s["replaces"],
         # the count on the kernel's first path (kernel 5's on the 2x2
         # mesh); every path's count beside it
         "launches": (launches[s["launch_path"]][r["name"]]
                      if "launch_path" in s else
                      next((launches[p][r["name"]] for p in s["per_fold"]),
                           0)),
         "launches_by_path": {p: launches[p][r["name"]] for p in launches},
         "max_abs_err": r["max_abs_err"], "ms": r["device_kernel_ms"],
         "plain_ms": r["device_plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["device_library_ms"]}
        for r, s in zip(results, specs)]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--poll"]:
        sys.exit(poll_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--dist-rank"]:
        sys.exit(dist_child_main(sys.argv[2:]))
    sys.exit(main())
