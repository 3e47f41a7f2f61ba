"""Command-line tools of the port: ``python -m dmlc_core_tpu_torch.tools``.

The port of ``dmlc_core_tpu/tools``, with the same arguments and output.
Every subcommand that takes a URI takes any registered scheme (file,
s3, gs, hdfs, azure, http, mem).

- ``ls``, ``cat``, ``cp``: list a directory, print a file's bytes, copy
  one URI to another (the reference's ``filesys_test``).
- ``split``: stream one part of a sharded URI, with record counts and
  bytes, or the records with ``--dump`` (``split_test``).
- ``recordio pack|unpack``: one record a line, and back; ``--codec``
  packs compressed blocks, ``--index`` writes the count index.
- ``rowrec``: a libsvm, csv or libfm dataset (or one part of it) to a
  rowrec ``.rec`` with its index, optionally compressed.
- ``recompress``: a ``.rec`` between codecs in one stream pass.
- ``dump``: parsed rows back to text (rowrec to libsvm by default).
- ``ckpt ls|show|prune``: a checkpoint directory's steps (single-file and
  sharded ``.d`` alike), a step's tree shapes and data position, and
  retention.
- ``info``: the runtime feature report (``build_info()``: the parse core,
  codecs, env flags, torch, CUDA and each device, the CUDA kernels'
  source hash). ``info <uri>`` adds an indexed shard's key count and
  block geometry (``io/lookup.py``), or for a stream shard still being
  written its committed prefix and uncommitted tail.
- ``serve``: the point-lookup daemon over one indexed shard
  (``io/lookup.py``), with ``/metrics``.
- ``trace dump|merge|report``: the flight recorder's operator surface.
- ``top``: a live dashboard over the tracker's ``/metrics.json?window=``
  (with the shard queue depth of a dynamic-shard job).
- ``journal inspect``: the tracker's control-plane journal, record by
  record.
- ``dsserve serve``: one dsserve preprocessing worker in the foreground
  (what ``submit --dsserve N`` launches N of).
- ``autoscale replay``: the autoscale controller's decisions replayed
  over an end-of-job report's time series.
- ``cached serve|stats|flush``: the host-shared decoded-block cache
  daemon (what ``submit --block-cache`` launches) and its operator
  queries.

Importing this module loads no torch: each command imports what it runs.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
from typing import List, Optional

from ..utils.logging import Error

__all__ = ["main"]

_COPY_CHUNK = 4 << 20


def _cmd_ls(args) -> int:
    from ..io.filesystem import FileSystem

    fs = FileSystem.get_instance(args.uri)
    lister = fs.list_directory_recursive if args.recursive else fs.list_directory
    for info in lister(args.uri):
        print(f"{info.size:>12}  {info.path}")
    return 0


def _cmd_cat(args) -> int:
    from ..io.stream import Stream

    with Stream.create(args.uri, "r") as s:
        while True:
            buf = s.read(_COPY_CHUNK)
            if not buf:
                break
            sys.stdout.buffer.write(buf)
    sys.stdout.buffer.flush()
    return 0


def _cmd_cp(args) -> int:
    from ..io.stream import Stream

    with Stream.create(args.src, "r") as src, Stream.create(args.dst, "w") as dst:
        n = 0
        while True:
            buf = src.read(_COPY_CHUNK)
            if not buf:
                break
            dst.write(buf)
            n += len(buf)
    print(f"copied {n} bytes {args.src} -> {args.dst}", file=sys.stderr)
    return 0


def _cmd_split(args) -> int:
    """One part of a URI: its record count and bytes, and with
    ``--dump`` the records themselves (a newline after each text
    record)."""
    from ..io import split as io_split

    sp = io_split.create(args.uri, args.part, args.num_parts, type=args.type,
                         threaded=False)
    records = 0
    nbytes = 0
    try:
        while True:
            rec = sp.next_record()
            if rec is None:
                break
            records += 1
            nbytes += len(rec)
            if args.dump:
                sys.stdout.buffer.write(bytes(rec))
                if args.type == "text":
                    sys.stdout.buffer.write(b"\n")
    finally:
        sp.close()
    print(f"part {args.part}/{args.num_parts}: {records} records, {nbytes} bytes",
          file=sys.stderr)
    return 0


def _cmd_recordio(args) -> int:
    """pack: one record per input line; unpack: the records back to
    lines (the frame format carries any bytes)."""
    from ..io.recordio import IndexedRecordIOWriter, RecordIOReader, RecordIOWriter
    from ..io.stream import Stream

    if args.action == "pack":
        if not args.dst:
            print("error: recordio pack needs a dst URI", file=sys.stderr)
            return 2
        with contextlib.ExitStack() as stack:
            dst = stack.enter_context(Stream.create(args.dst, "w"))
            codec = _codec_arg(args)
            writer = (
                IndexedRecordIOWriter(dst, stack.enter_context(Stream.create(args.index, "w")),
                                      codec=codec, level=args.level)
                if args.index
                else RecordIOWriter(dst, codec=codec, level=args.level)
            )
            n = _pack_lines(args.src, writer)
            writer.flush_block()
        print(f"packed {n} records", file=sys.stderr)
    else:
        with Stream.create(args.src, "r") as src:
            n = 0
            for rec in RecordIOReader(src):
                sys.stdout.buffer.write(rec)
                sys.stdout.buffer.write(b"\n")
                n += 1
        print(f"unpacked {n} records", file=sys.stderr)
    return 0


def _pack_lines(src_uri: str, writer) -> int:
    """One record per line, through the text splitter. Blank lines are
    not records: the line splitter takes a run of \\n/\\r as one
    separator."""
    from ..io import split as io_split

    sp = io_split.create(src_uri, 0, 1, type="text", threaded=False)
    n = 0
    try:
        while True:
            line = sp.next_record()
            if line is None:
                return n
            writer.write_record(bytes(line))
            n += 1
    finally:
        sp.close()


def _codec_arg(args):
    """The ``--codec`` option as a writer's codec argument (``none``: v1
    frames)."""
    codec = getattr(args, "codec", "none")
    return None if codec in ("", "none") else codec


def _cmd_rowrec(args) -> int:
    """A text dataset to a rowrec ``.rec`` (and its count index);
    ``--part/--num-parts`` convert one record-aligned part, ``--codec``
    packs the rows into compressed blocks."""
    from ..data import create_parser
    from ..data.rowrec import write_rowrec
    from ..io.stream import Stream

    parser = create_parser(args.src, args.part, args.num_parts, type=args.format,
                           threaded=False)
    try:
        with contextlib.ExitStack() as stack:
            dst = stack.enter_context(Stream.create(args.dst, "w"))
            idx = stack.enter_context(Stream.create(args.index, "w")) if args.index else None
            n = write_rowrec(dst, iter(parser), index_stream=idx, codec=_codec_arg(args),
                             level=args.level)
    finally:
        parser.close()
    print(f"wrote {n} rows to {args.dst}", file=sys.stderr)
    return 0


def _cmd_recompress(args) -> int:
    """A ``.rec`` (and a fresh index with ``--index``) to another codec
    in one stream pass: the records are read through ``RecordIOReader``
    (v1 frames and compressed blocks alike) and written again;
    ``--codec none`` gives v1 frames back."""
    from ..io.recordio import (
        DEFAULT_BLOCK_BYTES,
        IndexedRecordIOWriter,
        RecordIOReader,
        RecordIOWriter,
    )
    from ..io.stream import Stream

    codec = _codec_arg(args)
    block_bytes = args.block_bytes or DEFAULT_BLOCK_BYTES
    n = 0
    with contextlib.ExitStack() as stack:
        src = stack.enter_context(Stream.create(args.src, "r"))
        dst = stack.enter_context(Stream.create(args.dst, "w"))
        writer = (
            IndexedRecordIOWriter(dst, stack.enter_context(Stream.create(args.index, "w")),
                                  codec=codec, level=args.level, block_bytes=block_bytes)
            if args.index
            else RecordIOWriter(dst, codec=codec, level=args.level, block_bytes=block_bytes)
        )
        for rec in RecordIOReader(src):
            writer.write_record(rec)
            n += 1
        writer.flush_block()
        out_bytes = writer.bytes_written
    print(f"recompressed {n} records -> {args.dst} "
          f"(codec={codec or 'none'}, {out_bytes} bytes)", file=sys.stderr)
    return 0


def _cmd_dump(args) -> int:
    """Parsed rows as text on stdout (a rowrec ``.rec`` as libsvm unless
    the URI names a ``?format=``): ``%.9g`` keeps f32 labels, weights and
    values exact, qid and libfm fields are written when present, and a
    binary feature as its bare index; ``--limit`` stops after N rows."""
    from ..data import create_parser
    from ..io.uri import URISpec

    uspec = URISpec(args.src, args.part, args.num_parts)
    uri = args.src
    if "format" not in uspec.args:
        head, sep, frag = uri.partition("#")
        head += ("&" if "?" in head else "?") + "format=rowrec"
        uri = head + sep + frag
    parser = create_parser(uri, args.part, args.num_parts, threaded=False)
    rows = 0
    out = sys.stdout
    try:
        for blk in iter(parser):
            weights, qid, field, vals = blk.weight, blk.qid, blk.field, blk.value
            for i in range(blk.size):
                b, e = int(blk.offset[i]), int(blk.offset[i + 1])
                label = f"{float(blk.label[i]):.9g}"
                if weights is not None and float(weights[i]) != 1.0:
                    label += f":{float(weights[i]):.9g}"
                toks = [label]
                if qid is not None:
                    toks.append(f"qid:{int(qid[i])}")
                for j in range(b, e):
                    idx = int(blk.index[j])
                    if field is not None:
                        v = 1.0 if vals is None else float(vals[j])
                        toks.append(f"{int(field[j])}:{idx}:{v:.9g}")
                    elif vals is None:
                        toks.append(str(idx))
                    else:
                        toks.append(f"{idx}:{float(vals[j]):.9g}")
                out.write(" ".join(toks) + "\n")
                rows += 1
                if args.limit and rows >= args.limit:
                    print(f"dumped {rows} rows (limit)", file=sys.stderr)
                    return 0
    finally:
        parser.close()
    print(f"dumped {rows} rows", file=sys.stderr)
    return 0


def _cmd_ckpt(args) -> int:
    """A checkpoint directory on any URI: ``ls`` its steps with layout
    (``single`` or ``sharded``) and bytes, ``show`` a step's tree shapes
    and saved meta, ``prune`` to ``--keep`` steps (0 or less keeps all),
    through ``Checkpointer``'s ``steps_info``, ``restore``,
    ``restore_meta`` and ``prune``. A sharded step is assembled whole on
    the host."""
    import json

    from ..checkpoint import Checkpointer

    ck = Checkpointer(args.base)
    if args.action == "ls":
        print(json.dumps(ck.steps_info(), indent=2))
        return 0
    if args.action == "show":
        try:
            step, tree = ck.restore(args.step)
        except (Error, OSError) as e:
            sys.stderr.write(
                f"error: no readable checkpoint "
                f"{'step %s ' % args.step if args.step is not None else ''}"
                f"under {args.base}: {e}\n")
            return 1

        def describe(t):
            if isinstance(t, dict):
                return {k: describe(v) for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return [describe(v) for v in t]
            if hasattr(t, "shape") and hasattr(t, "dtype"):
                return f"{t.dtype}{list(t.shape)}"
            return repr(t)

        out = {"step": step, "tree": describe(tree)}
        # an unreadable meta sidecar costs the meta, not the tree
        try:
            meta = ck.restore_meta(step)
        except (Error, OSError) as e:
            meta = None
            sys.stderr.write(f"warning: unreadable checkpoint meta: {e}\n")
        if meta is not None:
            out["meta"] = meta
        print(json.dumps(out, indent=2, default=str))
        return 0
    # --keep as given: 0 or less keeps every step, as Checkpointer does
    removed = ck.prune(keep=args.keep)
    print(json.dumps({"kept": ck.steps(), "removed": removed}))
    return 0


def _cmd_info(args) -> int:
    """Runtime feature report (build_info): the parse core, env flags,
    the torch runtime and the kernels, as JSON. With a shard URI, also
    the indexed shard's key count and block geometry (``RecordLookup.
    describe``), or, for a shard still being written (a stream's live
    generation), its whole-frame prefix with the tail in flight reported
    as uncommitted."""
    import json

    from .. import build_info

    report = build_info()
    if getattr(args, "uri", None):
        from ..io.lookup import RecordLookup

        handle = None
        try:
            handle = RecordLookup(args.uri, args.index or None)
            report["shard"] = handle.describe()
        except (Error, OSError, ValueError):
            # a growing shard: its index tail or last block may be mid-write
            from ..stream import manifest as stream_manifest

            scan = stream_manifest.scan_committed_prefix(args.uri)
            scan["status"] = f"growing (tail_bytes={scan['tail_bytes']} uncommitted)"
            report["shard"] = scan
        finally:
            if handle is not None:
                handle.close()
    print(json.dumps(report, indent=2))
    return 0


def _cmd_serve(args) -> int:
    """The point-lookup daemon (``io/lookup.py``): batched ``lookup(keys)``
    over one indexed shard on a TCP request loop, with p50/p99 latency
    and qps on ``/metrics``. ``--warm N`` prefetches the shard's N hottest
    blocks first; ``--port-file`` writes a JSON readiness file. SIGTERM
    ends it with rc 0 after a last JSON stats line on stderr."""
    import json
    import signal

    from ..dsserve.server import write_port_file
    from ..io.lookup import LookupServer, RecordLookup
    from ..telemetry import tracing

    tracing.set_process_label("lookup-daemon")
    handle = RecordLookup(args.uri, args.index or None)
    if args.warm:
        print(f"warmed {handle.warm(max_blocks=args.warm)} blocks", file=sys.stderr)
    server = LookupServer(handle, host=args.host, port=args.port,
                          metrics_port=args.metrics_port)
    if args.port_file:
        write_port_file(args.port_file, args.host, server.port)
    signal.signal(signal.SIGTERM, lambda *_a: server.close())
    print(f"lookup daemon pid {os.getpid()} serving {args.host}:{server.port} over "
          f"{args.uri}" + (f" (/metrics on 127.0.0.1:{args.metrics_port})"
                           if args.metrics_port else ""), file=sys.stderr)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
        # the stats before handle.close(): their shard section reads
        # through the handle
        stats = server.stats()
        handle.close()
        print(json.dumps(stats), file=sys.stderr)
    return 0


def _cmd_dsserve(args) -> int:
    """Operator surface for the disaggregated preprocessing tier
    (``dsserve/``):

    - ``serve``: run one preprocessing worker in the foreground (what
      ``submit --dsserve N`` launches N of, next to the tracker) until
      SIGINT/SIGTERM. With a tracker in the environment
      (``DMLC_TRACKER_URI``/``PORT``) the server leases micro-shards;
      ``--port-file`` writes the bound endpoint as a JSON readiness
      signal for launchers; ``--port 0`` binds any free port. SIGTERM
      is the GRACEFUL retire signal: the server finishes the shard it
      is producing, EPOCH_ENDs its streams, releases every held lease,
      then exits zero — so a scale-down (or an operator's drain) never
      strands a lease to its TTL.
    """
    import json
    import signal

    from ..dsserve.server import DsServeServer, write_port_file
    from ..telemetry import tracing

    tracing.set_process_label("dsserve-worker")
    server = DsServeServer(args.host, args.port, rank=args.rank)
    if args.port_file:
        write_port_file(args.port_file, args.host, server.port)
    signal.signal(signal.SIGTERM, lambda *_a: server.retire())
    print(
        f"dsserve worker pid {os.getpid()} rank {server.rank} serving "
        f"{args.host}:{server.port}"
        + (" (tracker-leased shards)"
           if os.environ.get("DMLC_TRACKER_URI") else " (static stripes)"),
        file=sys.stderr,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
        print(json.dumps(server.stats()), file=sys.stderr)
    return 0


def _cmd_trace(args) -> int:
    """Operator surface for the flight recorder (telemetry/tracing.py):

    - ``dump <pid>``: SIGUSR2 the process — its installed handler
      writes the span rings to ``DMLC_TRACE_DIR`` (or the temp dir)
      without stopping it.
    - ``merge -o out.json in...json``: join per-process trace files
      from a submit run (workers + tracker, of either package)
      into ONE Perfetto-loadable timeline keyed by rank/pid.
    - ``report trace.json``: stall attribution — per-stage busy/stall
      seconds, ring-starvation gaps over ``--gap-ms``, critical-path
      estimate per process.
    """
    import json
    import signal as _signal

    from ..telemetry import tracing

    if args.action == "dump":
        # `trace dump 1234` and `trace dump --pid 1234` both work — a
        # positional pid lands in the inputs list
        pid = args.pid
        if not pid and len(args.inputs) == 1 and args.inputs[0].isdigit():
            pid = int(args.inputs[0])
        if not pid:
            print("error: trace dump needs a pid", file=sys.stderr)
            return 2
        try:
            os.kill(pid, _signal.SIGUSR2)
        except (OSError, AttributeError) as e:
            print(f"error: cannot signal pid {pid}: {e}",
                  file=sys.stderr)
            return 1
        where = os.environ.get("DMLC_TRACE_DIR") or "its temp dir"
        print(
            f"SIGUSR2 sent to {pid}; it dumps "
            f"dmlc-trace-<label>-{pid}.json into its own "
            f"DMLC_TRACE_DIR (here: {where})",
            file=sys.stderr,
        )
        return 0
    if args.action == "merge":
        if not args.out or len(args.inputs) < 1:
            print("error: trace merge needs -o OUT and >=1 input",
                  file=sys.stderr)
            return 2
        merged = tracing.merge_traces(
            args.inputs, align_clocks=args.align_clocks
        )
        tracing.write_trace(merged, args.out)
        print(
            f"merged {merged['otherData']['merged']} trace(s), "
            f"{len(merged['traceEvents'])} events -> {args.out} "
            f"(load in https://ui.perfetto.dev)",
            file=sys.stderr,
        )
        return 0
    # report
    if len(args.inputs) != 1:
        print("error: trace report takes exactly one trace file",
              file=sys.stderr)
        return 2
    report = tracing.stall_report(
        tracing.load_trace(args.inputs[0]), gap_ms=args.gap_ms
    )
    if args.json:
        print(json.dumps(report, indent=2))
        return 0
    print(f"stall attribution for {args.inputs[0]} "
          f"(gap threshold {args.gap_ms} ms)")
    print("\nper-stage time (busy = work, stall = waiting):")
    stages = sorted(
        set(report["busy_seconds_by_stage"])
        | set(report["stall_seconds_by_stage"])
    )
    for s in stages:
        b = report["busy_seconds_by_stage"].get(s)
        w = report["stall_seconds_by_stage"].get(s)
        kind = "stall" if w is not None else "busy"
        secs = w if w is not None else b
        n = report["span_counts_by_stage"].get(s, 0)
        print(f"  {s:<24} {kind:<5} {secs:>10.4f}s  ({n} spans)")
    print("\nthreads (busy/idle inside each thread's span extent):")
    for name, t in sorted(report["threads"].items()):
        print(f"  {name:<40} busy {t['busy_seconds']:.4f}s  "
              f"idle {t['idle_seconds']:.4f}s  "
              f"wall {t['wall_seconds']:.4f}s")
    gaps = report["starvation_gaps"]
    print(f"\nstarvation gaps >= {args.gap_ms} ms: {len(gaps)}")
    for g in gaps[:10]:
        print(f"  {g['duration_ms']:>10.2f} ms  {g['stage']:<20} "
              f"{g['process']} / {g['thread']}")
    print("\ncritical-path estimate per process:")
    for proc, c in report["critical_path"].items():
        top = list(c["attributed_seconds"].items())[:3]
        attr = ", ".join(f"{k} {v:.3f}s" for k, v in top)
        print(f"  {proc}: wall {c['wall_seconds']:.3f}s, bottleneck "
              f"thread {c['bottleneck_thread']} ({attr}; "
              f"unattributed {c['unattributed_seconds']:.3f}s)")
    return 0




def _cmd_journal(args) -> int:
    """The tracker's control-plane journal (``tracker/journal.py``): the
    snapshot and every WAL record (seq, kind, CRC status), a torn tail,
    and whether a strict replay would refuse the directory. Exit 1 on
    CRC damage (with ``--json`` also on a missing directory)."""
    import json

    from ..tracker import journal as _journal

    dump = _journal.inspect_journal(args.dir)
    if args.json:
        print(json.dumps(dump, indent=2, default=str))
        return 1 if (dump["crc_failures"] or not os.path.isdir(args.dir)) else 0
    snap = dump["snapshot"]
    if snap is None:
        print("snapshot: none")
    elif "error" in snap:
        print(f"snapshot: CORRUPT ({snap['error']})")
    else:
        st = snap.get("state") or {}
        shards = st.get("shards") or {}
        print(f"snapshot: seq={snap['seq']} "
              f"fileset={shards.get('fileset')!r} "
              f"epochs={len(shards.get('epochs') or {})} "
              f"ranks={len(st.get('ranks') or {})}")
    for r in dump["records"]:
        status = "ok" if r["crc_ok"] else "CRC-FAIL"
        print(f"wal @{r['offset']:<8d} seq={r['seq']} kind={r['kind']} [{status}]")
    if dump["torn_tail_at"] is not None:
        print(f"torn tail at byte {dump['torn_tail_at']} "
              "(truncated on next writable open — an interrupted append, "
              "not corruption)")
    n_bad = dump["crc_failures"]
    print(f"{len(dump['records'])} WAL record(s), {n_bad} CRC failure(s)")
    if n_bad:
        print("strict replay would REFUSE this journal (CRC damage)")
        return 1
    return 0


def _top_endpoint(raw: str) -> str:
    """Normalize the endpoint argument: full URL, host:port, or a bare
    port (loopback — the tracker binds 127.0.0.1)."""
    raw = (raw or "").strip()
    if not raw:
        raw = os.environ.get("DMLC_METRICS_PORT", "")
    if not raw:
        raise Error(
            "tools top needs the tracker metrics endpoint (a URL, "
            "host:port or port — the tracker logs 'telemetry endpoint "
            "on 127.0.0.1:PORT/metrics' at start, or pin it with "
            "DMLC_METRICS_PORT)"
        )
    if raw.isdigit():
        raw = f"127.0.0.1:{raw}"
    if not raw.startswith(("http://", "https://")):
        raw = f"http://{raw}"
    return raw.rstrip("/")


def _top_model(report: dict, window: float) -> dict:
    """Flatten a ``/metrics.json?window=`` report into the dashboard's
    model (also the ``--once --json`` output): per-rank and cluster
    rows/s, stall fractions, queue depth, cache hit rates, service
    QPS/p99. Pure — unit-testable without a tracker."""
    win = report.get("windowed") or {}
    per_rank = win.get("per_rank") or {}
    cluster = win.get("cluster") or {}
    def rank_order(kv):
        # tracker row first, then ranks NUMERICALLY (string sort puts
        # rank 10 before rank 2 on a 12-worker job)
        rank = kv[0]
        if rank == "tracker":
            return (0, 0, rank)
        try:
            return (1, int(rank), rank)
        except ValueError:
            return (2, 0, rank)

    ranks = {}
    for rank, view in sorted(per_rank.items(), key=rank_order):
        d = view.get("derived") or {}
        ranks[rank] = {
            "rows_per_sec": d.get("rows_per_sec", 0.0),
            "stall_fraction": d.get("stall_fraction", {}),
            "samples": view.get("samples", 0),
            **{
                k: d[k]
                for k in (
                    "block_cache_hit_rate",
                    "decode_cache_hit_rate",
                    "lookup_qps",
                    "lookup_p99_ms",
                    "dsserve_slots_per_sec",
                    "dsserve_wire_ratio",
                    "dsserve_shm_frac",
                    "shard_queue_depth",
                    "stream_lag_seconds",
                    "stream_lag_records",
                    "stream_watermark_records",
                )
                if k in d
            },
        }
    cd = cluster.get("derived") or {}
    # the shard queue depth lives on the tracker pseudo-rank's gauges
    qd = (
        (per_rank.get("tracker") or {})
        .get("gauges", {})
        .get("tracker.shards.queue_depth")
    )
    model = {
        "window_secs": window,
        "n_ranks": cluster.get("n_ranks", 0),
        "ranks": ranks,
        "cluster": cd,
    }
    if qd is not None:
        model["shard_queue_depth"] = qd
    # autoscale controller status (tracker/autoscale.py registers it as
    # a report section; absent on fixed-fleet jobs)
    if isinstance(report.get("autoscale"), dict):
        model["autoscale"] = report["autoscale"]
    return model


def _bar(frac: float, width: int = 10) -> str:
    frac = max(0.0, min(1.0, float(frac)))
    n = int(round(frac * width))
    return "█" * n + "·" * (width - n)


def _fmt_rate(v: float) -> str:
    if v >= 1e6:
        return f"{v / 1e6:.2f}M"
    if v >= 1e3:
        return f"{v / 1e3:.1f}k"
    return f"{v:.1f}"


def _render_top(model: dict, endpoint: str) -> str:
    lines = [
        f"dmlc top — {endpoint}  window={model['window_secs']:g}s  "
        f"ranks={model['n_ranks']}"
    ]
    cd = model.get("cluster") or {}
    summary = [f"cluster rows/s {_fmt_rate(cd.get('rows_per_sec', 0.0))}"]
    if "shard_queue_depth" in model:
        summary.append(
            f"shard queue {model['shard_queue_depth'].get('last', 0):g}"
        )
    for key, label in (
        ("block_cache_hit_rate", "blockcache hit"),
        ("decode_cache_hit_rate", "decode hit"),
    ):
        if key in cd:
            summary.append(f"{label} {cd[key] * 100:.0f}%")
    if "lookup_qps" in cd:
        p99 = cd.get("lookup_p99_ms")
        summary.append(
            f"lookup {cd['lookup_qps']:g} qps"
            + (f" p99 {p99:g}ms" if p99 is not None else "")
        )
    if "dsserve_slots_per_sec" in cd:
        dss = f"dsserve {cd['dsserve_slots_per_sec']:g} slots/s"
        if "dsserve_wire_ratio" in cd:
            dss += f" wire {cd['dsserve_wire_ratio'] * 100:.0f}%"
        if "dsserve_shm_frac" in cd:
            dss += f" shm {cd['dsserve_shm_frac'] * 100:.0f}%"
        summary.append(dss)
    if "stream_lag_seconds" in cd:
        # slowest follower across the fleet (merge_windows takes max)
        summary.append(
            f"stream lag {cd['stream_lag_seconds']:.2f}s"
            f"/{cd.get('stream_lag_records', 0):g} recs"
        )
    lines.append("  ".join(summary))
    asc = model.get("autoscale")
    if asc:
        parts = [
            f"autoscale fleet {asc.get('actual', 0)}→"
            f"{asc.get('target', 0)} "
            f"(bounds {asc.get('min_workers', 0)}:"
            f"{asc.get('max_workers', 0)})"
        ]
        last = asc.get("last") or {}
        if last:
            parts.append(
                f"last {last.get('kind', '?')} ({last.get('reason', '?')})"
            )
        ceiling = asc.get("cost_ceiling") or 0
        parts.append(
            f"cost {asc.get('cost_spent', 0.0):.0f}"
            + (f"/{ceiling:g} ws" if ceiling else " ws")
        )
        if asc.get("direction_changes"):
            parts.append(f"flaps {asc['direction_changes']}")
        lines.append("  ".join(parts))
    lines.append("")
    # the lag column only appears on streaming jobs — a sealed-corpus
    # top keeps its exact layout
    has_lag = any(
        "stream_lag_seconds" in r
        for r in (model.get("ranks") or {}).values()
    )
    lag_head = f"{'lag':>8}  " if has_lag else ""
    lines.append(f"{'rank':>8}  {'rows/s':>10}  {lag_head}stall by stage")
    for rank, r in (model.get("ranks") or {}).items():
        stalls = sorted(
            (r.get("stall_fraction") or {}).items(),
            key=lambda kv: -kv[1],
        )[:3]
        stall_txt = "  ".join(
            f"{stage} {_bar(frac)} {frac * 100:.0f}%"
            for stage, frac in stalls
            if frac > 0
        )
        # data-plane mix for ranks draining dsserve: wire bytes per raw
        # byte (codec win when < 100%) and the shm/tcp slot split
        extras = []
        if "dsserve_wire_ratio" in r:
            extras.append(f"wire {r['dsserve_wire_ratio'] * 100:.0f}%")
        if "dsserve_shm_frac" in r:
            extras.append(f"shm {r['dsserve_shm_frac'] * 100:.0f}%")
        if extras:
            stall_txt = "  ".join(filter(None, [stall_txt, *extras]))
        lag_txt = ""
        if has_lag:
            if "stream_lag_seconds" in r:
                lag_txt = f"{r['stream_lag_seconds']:.2f}s".rjust(8) + "  "
            else:
                lag_txt = f"{'-':>8}  "
        lines.append(
            f"{rank:>8}  {_fmt_rate(r.get('rows_per_sec', 0.0)):>10}  "
            f"{lag_txt}{stall_txt}"
        )
    return "\n".join(lines)


def _cmd_top(args) -> int:
    """Live terminal dashboard over the tracker's windowed telemetry:
    polls ``/metrics.json?window=N`` and renders per-rank rows/s, the top
    stall stages as bars, shard queue depth, cache hit rates and
    service QPS/p99. ``--once`` renders one frame (``--json`` for the
    machine-readable model), the scripted mode."""
    import json as _json
    import time as _time

    from ..io import retry as _retry

    endpoint = _top_endpoint(args.endpoint)
    url = f"{endpoint}/metrics.json?window={args.window:g}"

    def fetch() -> dict:
        with _retry.request(url, timeout=10.0) as resp:
            return _json.loads(resp.read().decode())

    if args.once:
        model = _top_model(fetch(), args.window)
        if args.json:
            print(_json.dumps(model, indent=1))
        else:
            print(_render_top(model, endpoint))
        return 0
    try:
        while True:
            frame = _render_top(_top_model(fetch(), args.window), endpoint)
            # clear + home, then the frame (plain ANSI — no curses dep)
            sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
            sys.stdout.flush()
            _time.sleep(max(0.2, args.interval))
    except KeyboardInterrupt:
        return 0


def _cmd_cached(args) -> int:
    """Operator surface of the host-shared decoded-block cache
    (``io/blockcache.py``):

    - ``serve``: run the daemon in the foreground (what ``submit
      --block-cache`` launches) until SIGINT or SIGTERM; the segments it
      owns are unlinked on the way out;
    - ``stats``: one JSON snapshot of the daemon's store: entries,
      resident bytes, hits, misses, publishes, evictions, per tenant;
    - ``flush``: evict every unleased block (a leased segment stays: a
      mapped view is never unlinked under a reader).
    """
    import json
    import signal

    from ..io import blockcache
    from ..telemetry import tracing

    sock = args.socket or blockcache.default_sock_path()
    if args.action == "serve":
        # the serve process is the daemon: its row on the merged
        # flight-recorder timeline sits beside the workers' and tracker's
        tracing.set_process_label("blockcache-daemon")
        daemon = blockcache.BlockCacheDaemon(
            sock,
            max_bytes=(args.budget_mb << 20) if args.budget_mb else None,
            tenant_max_bytes=(args.tenant_mb << 20) if args.tenant_mb else None,
            metrics_port=args.metrics_port,
        )
        daemon.start()
        signal.signal(signal.SIGTERM, lambda *_a: daemon.close())
        print(f"block-cache daemon pid {daemon.stats()['pid']} serving {sock} "
              f"(budget {daemon.max_bytes >> 20} MB"
              + (f", /metrics on 127.0.0.1:{args.metrics_port}"
                 if args.metrics_port else "") + ")", file=sys.stderr)
        try:
            daemon.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            daemon.close()
        return 0
    client = blockcache.BlockCacheClient(sock)
    out = client.stats() if args.action == "stats" else client.flush()
    if out is None:
        print(f"error: no block-cache daemon at {sock}", file=sys.stderr)
        return 1
    print(json.dumps(out, indent=2) if args.action == "stats"
          else json.dumps({"evicted": out}))
    return 0


def _cmd_autoscale(args) -> int:
    """Offline surface of the elastic controller (tracker/autoscale.py):

    - ``replay <metrics-report.json>``: run the pure decision function
      over the time series recorded in an end-of-job report
      (``DMLC_METRICS_REPORT``) and print the decisions it would have
      made: deterministic and offline, so thresholds, dwell and ceiling
      can be tuned against a finished job. The simulated fleet tracks
      the decisions, so the printed cost is the plan's worker×seconds.
    """
    import json as _json

    from ..tracker import autoscale as _as

    with open(args.report) as f:
        report = _json.load(f)
    ts = report.get("timeseries")
    if not isinstance(ts, dict) or not ts.get("per_rank"):
        print(
            "error: report has no retained time series — need the "
            "end-of-job DMLC_METRICS_REPORT shape (a run with DMLC_TS "
            "sampling on)",
            file=sys.stderr,
        )
        return 1
    lo, sep, hi = str(args.fleet).partition(":")
    try:
        cfg = _as.AutoscaleConfig(
            min_workers=int(lo),
            max_workers=int(hi if sep else lo),
            up_threshold=args.up,
            down_threshold=args.down,
            dwell_secs=args.dwell,
            cost_ceiling=args.cost_ceiling,
            interval=max(0.1, args.interval),
            window=max(0.5, args.window),
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    decisions = _as.replay(ts, cfg, include_holds=not args.actions_only)
    if args.json:
        print(_json.dumps(decisions, indent=1))
        return 0
    for d in decisions:
        print(
            f"t+{d['t']:8.1f}s  {d['kind']:<10} {d['reason']:<14} "
            f"target={d['target']}  input {d.get('input_stall', 0.0):.2f}  "
            f"compute {d.get('compute_stall', 0.0):.2f}  "
            f"queue {d.get('queue_depth', 0.0):g}  "
            f"cost {d['cost_spent']:.0f}ws"
        )
    kinds = {}
    for d in decisions:
        kinds[d["kind"]] = kinds.get(d["kind"], 0) + 1
    total = decisions[-1]["cost_spent"] if decisions else 0.0
    print(
        f"# {len(decisions)} decisions "
        f"({', '.join(f'{k} {n}' for k, n in sorted(kinds.items()))}); "
        f"plan cost {total:.0f} worker-seconds"
    )
    return 0


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dmlc_core_tpu_torch.tools",
        description=__doc__.splitlines()[0],
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    ls = sub.add_parser("ls", help="list a directory URI")
    ls.add_argument("uri")
    ls.add_argument("-r", "--recursive", action="store_true")
    ls.set_defaults(fn=_cmd_ls)

    cat = sub.add_parser("cat", help="print a URI's bytes to stdout")
    cat.add_argument("uri")
    cat.set_defaults(fn=_cmd_cat)

    cp = sub.add_parser("cp", help="copy src URI to dst URI")
    cp.add_argument("src")
    cp.add_argument("dst")
    cp.set_defaults(fn=_cmd_cp)

    spl = sub.add_parser("split", help="stream one shard of a URI")
    spl.add_argument("uri")
    spl.add_argument("part", type=int)
    spl.add_argument("num_parts", type=int)
    spl.add_argument("--type", default="text",
                     choices=("text", "recordio", "indexed_recordio"))
    spl.add_argument("--dump", action="store_true", help="echo records to stdout")
    spl.set_defaults(fn=_cmd_split)

    def add_codec_opts(sp) -> None:
        from ..io.codec import available_codecs

        sp.add_argument("--codec", default="none", choices=["none"] + available_codecs(),
                        help="compress records into blocks (none = v1 frames)")
        sp.add_argument("--level", default=None, type=int,
                        help="codec compression level (codec default)")

    rio = sub.add_parser("recordio", help="pack/unpack line records")
    rio.add_argument("action", choices=("pack", "unpack"))
    rio.add_argument("src")
    rio.add_argument("dst", nargs="?", default="",
                     help="output URI (pack); unpack prints to stdout")
    rio.add_argument("--index", default="", help="also write a count index (pack only)")
    add_codec_opts(rio)
    rio.set_defaults(fn=_cmd_recordio)

    rr = sub.add_parser("rowrec", help="convert a text dataset to rowrec .rec")
    rr.add_argument("src", help="source URI (?format= honored)")
    rr.add_argument("dst", help="output .rec URI")
    rr.add_argument("--format", default="auto", choices=("auto", "libsvm", "csv", "libfm"))
    rr.add_argument("--index", default="", help="also write a count index")
    rr.add_argument("--part", default=0, type=int, help="convert only this shard of src")
    rr.add_argument("--num-parts", default=1, type=int)
    add_codec_opts(rr)
    rr.set_defaults(fn=_cmd_rowrec)

    rcx = sub.add_parser("recompress", help="convert a .rec between codecs in one stream pass")
    rcx.add_argument("src", help="source .rec URI (v1 or compressed)")
    rcx.add_argument("dst", help="output .rec URI")
    rcx.add_argument("--index", default="", help="write a fresh index sidecar for dst")
    rcx.add_argument("--block-bytes", default=None, type=int,
                     help="raw bytes buffered per compressed block")
    add_codec_opts(rcx)
    # recompress compresses unless told otherwise; --codec none converts
    # a compressed file back to v1 frames
    rcx.set_defaults(fn=_cmd_recompress, codec="zlib")

    dp = sub.add_parser("dump", help="decode a rowrec .rec back to libsvm text")
    dp.add_argument("src", help=".rec URI (shardable)")
    dp.add_argument("--part", default=0, type=int)
    dp.add_argument("--num-parts", default=1, type=int)
    dp.add_argument("--limit", default=0, type=int, help="stop after N rows (0 = all)")
    dp.set_defaults(fn=_cmd_dump)

    ck = sub.add_parser("ckpt", help="inspect/prune checkpoint directories (any URI)")
    ck.add_argument("action", choices=["ls", "show", "prune"])
    ck.add_argument("base", help="checkpoint base URI")
    ck.add_argument("--step", type=int, default=None,
                    help="step for 'show' (default: newest)")
    ck.add_argument("--keep", type=int, default=3, help="retention count for 'prune'")
    ck.set_defaults(fn=_cmd_ckpt)

    info = sub.add_parser(
        "info",
        help="runtime feature report (JSON); with a shard URI, also "
             "its index key count + block geometry",
    )
    info.add_argument(
        "uri", nargs="?", default="",
        help="optional indexed .rec URI to describe",
    )
    info.add_argument(
        "--index", default="",
        help="index sidecar URI (default <uri>.idx)",
    )
    info.set_defaults(fn=_cmd_info)

    sv = sub.add_parser(
        "serve", help="low-latency point-read daemon over an indexed shard"
    )
    sv.add_argument("uri", help="indexed .rec URI to serve")
    sv.add_argument(
        "--index", default="", help="index sidecar URI (default <uri>.idx)"
    )
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument(
        "--port", default=0, type=int, help="TCP port (0 = any free)"
    )
    sv.add_argument(
        "--port-file", default="",
        help="write a JSON readiness file naming the bound endpoint",
    )
    sv.add_argument(
        "--metrics-port", default=0, type=int,
        help="loopback /metrics port (0 = off)",
    )
    sv.add_argument(
        "--warm", default=0, type=int,
        help="prefetch the N hottest blocks before serving (0 = off)",
    )
    sv.set_defaults(fn=_cmd_serve)

    tr = sub.add_parser(
        "trace", help="flight-recorder dump/merge/report (Perfetto)"
    )
    tr.add_argument("action", choices=["dump", "merge", "report"])
    tr.add_argument(
        "inputs", nargs="*",
        help="trace JSON files (merge: many; report: one)",
    )
    tr.add_argument(
        "--pid", default=0, type=int,
        help="dump: process to SIGUSR2 (it writes its own rings)",
    )
    tr.add_argument(
        "-o", "--out", default="",
        help="merge: output trace JSON path",
    )
    tr.add_argument(
        "--gap-ms", default=10.0, type=float,
        help="report: minimum wait-span duration counted as a "
             "starvation gap (default 10)",
    )
    tr.add_argument(
        "--json", action="store_true",
        help="report: emit the full report as JSON",
    )
    tr.add_argument(
        "--align-clocks", action="store_true",
        help="merge: shift each file's timestamps by its recorded "
             "heartbeat-RTT clock offset (multi-HOST runs; same-host "
             "files already share a wall clock)",
    )
    tr.set_defaults(fn=_cmd_trace)

    top = sub.add_parser(
        "top",
        help="live cluster dashboard over the tracker's "
             "/metrics.json?window= endpoint",
    )
    top.add_argument(
        "endpoint", nargs="?", default="",
        help="tracker metrics endpoint: URL, host:port or bare port "
             "(the tracker logs 'telemetry endpoint on ...' at start)",
    )
    top.add_argument(
        "--window", default=30.0, type=float,
        help="rate window in seconds (default 30)",
    )
    top.add_argument(
        "--interval", default=2.0, type=float,
        help="refresh interval in seconds (default 2)",
    )
    top.add_argument(
        "--once", action="store_true",
        help="render one frame and exit (scripts/tests)",
    )
    top.add_argument(
        "--json", action="store_true",
        help="with --once: print the derived model as JSON",
    )
    top.set_defaults(fn=_cmd_top)

    asc = sub.add_parser(
        "autoscale",
        help="offline elastic-controller tools (replay recorded runs)",
    )
    asc.add_argument("action", choices=["replay"])
    asc.add_argument(
        "report",
        help="end-of-job metrics report JSON (DMLC_METRICS_REPORT)",
    )
    asc.add_argument(
        "--fleet", default="1:4", metavar="MIN:MAX",
        help="fleet bounds to simulate (default 1:4)",
    )
    asc.add_argument(
        "--up", default=0.40, type=float,
        help="input-stall fraction that triggers scale-up (default 0.40)",
    )
    asc.add_argument(
        "--down", default=0.10, type=float,
        help="input-stall fraction that triggers retire (default 0.10)",
    )
    asc.add_argument(
        "--dwell", default=10.0, type=float,
        help="minimum seconds between scale actions (default 10)",
    )
    asc.add_argument(
        "--cost-ceiling", default=0.0, type=float,
        help="worker-seconds budget (0 = unlimited)",
    )
    asc.add_argument(
        "--interval", default=2.0, type=float,
        help="controller tick to simulate (default 2)",
    )
    asc.add_argument(
        "--window", default=10.0, type=float,
        help="windowed-view width per decision (default 10)",
    )
    asc.add_argument(
        "--actions-only", action="store_true",
        help="print only scale actions, not holds",
    )
    asc.add_argument(
        "--json", action="store_true",
        help="emit the decision list as JSON",
    )
    asc.set_defaults(fn=_cmd_autoscale)

    cd = sub.add_parser(
        "cached", help="host-level shared decoded-block cache daemon"
    )
    cd.add_argument("action", choices=["serve", "stats", "flush"])
    cd.add_argument(
        "--socket", default="",
        help="UNIX socket path (default: $DMLC_BLOCK_CACHE_SOCK or the "
             "uid-scoped temp-dir path)",
    )
    cd.add_argument(
        "--budget-mb", default=0, type=int,
        help="serve: total resident budget (default "
             "$DMLC_BLOCK_CACHE_MB or 1024)",
    )
    cd.add_argument(
        "--tenant-mb", default=0, type=int,
        help="serve: per-tenant byte quota (default the whole budget)",
    )
    cd.add_argument(
        "--metrics-port", default=0, type=int,
        help="serve: loopback /metrics port (0 = off)",
    )
    cd.set_defaults(fn=_cmd_cached)

    ds = sub.add_parser(
        "dsserve", help="disaggregated preprocessing worker (dsserve://)"
    )
    ds.add_argument("action", choices=["serve"])
    ds.add_argument("--host", default="127.0.0.1")
    ds.add_argument(
        "--port", default=0, type=int,
        help="listen port (0 = any free port; see --port-file)",
    )
    ds.add_argument(
        "--port-file", default="",
        help="write the bound endpoint here as JSON once listening "
             "(the dmlc-submit launcher's readiness signal)",
    )
    ds.add_argument(
        "--rank", default=None, type=int,
        help="shard-lease identity (default $DMLC_TASK_ID)",
    )
    ds.set_defaults(fn=_cmd_dsserve)

    jr = sub.add_parser(
        "journal",
        help="inspect a tracker control-plane journal directory",
    )
    jr.add_argument("action", choices=["inspect"])
    jr.add_argument("dir", help="journal directory (--tracker-journal)")
    jr.add_argument("--json", action="store_true", default=False,
                    help="machine-readable dump")
    jr.set_defaults(fn=_cmd_journal)

    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)
    try:
        return args.fn(args)
    except (Error, OSError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
