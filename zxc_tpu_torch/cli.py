"""zxc-compatible command-line interface of the PyTorch port, run as
``python -m zxc_tpu_torch``; the counterpart of ``zxc_tpu.cli``.

Mirrors the reference CLI surface (src/cli/main.c:490-523): modes
-z/-d/-l/-t/-b/--train, multi/recursive input, levels -1..-7, block size,
checksum toggles, dictionaries, seekable output, stdout/keep/force, verbose
and quiet, JSON bench output, progress policy. Host commands run the
native codec; ``--device`` routes decode through the port's device paths
on the card (``ops.decompress``, or ``decompress_e2e`` with a ``.zxh``
hint under ``--hints``) and compression through ``ops.compress_device``
(no dictionary, no seek table). ``--device`` without CUDA exits 1: the
CLI never falls back to the CPU. ``main(..., device="cpu")`` runs the
device commands on the kernels' plain versions, for tests.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

from . import constants as C
from .errors import ZxcError
from .format.dictionary import Dictionary
from .codec import frame
from .codec.frame import DecodeOpts, EncodeOpts

VERSION = "0.1.0"
SUFFIX = ".zxc"


def _fmt_size(n: int) -> str:
    """Decimal size string (reference format_size_decimal)."""
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if n >= div:
            return f"{n / div:.1f} {unit}"
    return f"{n} B"


class Progress:
    """Reference-rendering progress bar (src/cli/main.c:570-690):

    ``Compressing [=====>        ] 45% | 4.5 MB/10.0 MB | 156.0 MB/s | ETA 0:35``

    Frames are throttled (100 ms on a tty, 1 s otherwise) and emitted as
    ONE stderr write; off-tty --progress=always prints newline-terminated
    updates; the final frame is cleared with padded spaces. Policy
    auto/always/never matches main.c:312-330 (auto = tty only)."""

    BAR_WIDTH = 20

    def __init__(self, policy: str, total: int, label: str,
                 operation: str = "Compressing"):
        self.to_tty = sys.stderr.isatty()
        self.enabled = (policy == "always"
                        or (policy == "auto" and self.to_tty))
        self.total = total
        self.op = operation
        self.label = label
        self.done = 0
        self.t0 = time.time()
        self.last_draw = 0.0
        self.last_len = 0

    def _text(self) -> str:
        elapsed = time.time() - self.t0
        speed = (self.done / 1e6 / elapsed) if elapsed > 0.1 else 0.0
        if self.total > 0:
            pct = min(100, self.done * 100 // self.total)
            filled = pct * self.BAR_WIDTH // 100
            bar = ("=" * filled + (">" if filled < self.BAR_WIDTH else "")
                   ).ljust(self.BAR_WIDTH)
            eta = ""
            if speed > 0 and self.total > self.done:
                secs = int((self.total - self.done) / (speed * 1e6))
                eta = (f" | ETA {secs // 3600}:{(secs // 60) % 60:02d}:"
                       f"{secs % 60:02d}" if secs >= 3600
                       else f" | ETA {secs // 60}:{secs % 60:02d}")
            return (f"{self.op} [{bar}] {pct}% | {_fmt_size(self.done)}/"
                    f"{_fmt_size(self.total)} | {speed:.1f} MB/s{eta}")
        return f"{self.op} {_fmt_size(self.done)} | {speed:.1f} MB/s"

    def update(self, n: int):
        if not self.enabled:
            return
        self.done += n
        now = time.time()
        interval = 0.1 if self.to_tty else 1.0
        if self.last_draw and now - self.last_draw < interval:
            return
        self.last_draw = now
        text = self._text()
        if self.to_tty:
            pad = " " * max(0, self.last_len - len(text))
            sys.stderr.write("\r" + text + pad)
            self.last_len = len(text)
        else:
            sys.stderr.write(text + "\n")
        sys.stderr.flush()

    def finish(self):
        if not self.enabled:
            return
        if self.to_tty:  # clear the line (reference zxc_progress_clear)
            sys.stderr.write("\r" + " " * self.last_len + "\r")
            sys.stderr.flush()
        else:
            sys.stderr.write(self._text() + "\n")
            sys.stderr.flush()


class Log:
    def __init__(self, verbose: bool, quiet: bool):
        self.verbose = verbose
        self.quiet = quiet

    def info(self, *a):
        if not self.quiet:
            print(*a, file=sys.stderr)

    def debug(self, *a):
        if self.verbose and not self.quiet:
            print(*a, file=sys.stderr)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="zxc", add_help=True,
        description="ZXC v7 codec (GPU-native implementation)")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("-z", "--compress", action="store_true")
    mode.add_argument("-d", "--decompress", action="store_true")
    mode.add_argument("-l", "--list", action="store_true",
                      help="list archive or dictionary info")
    mode.add_argument("-t", "--test", action="store_true",
                      help="test compressed file integrity")
    mode.add_argument("-b", "--bench", nargs="?", const=5, type=int,
                      metavar="N", help="benchmark in-memory (N seconds)")
    mode.add_argument("--train", action="store_true",
                      help="train a dictionary from input files")
    p.add_argument("-m", "--multiple", action="store_true")
    p.add_argument("-r", "--recursive", action="store_true")
    p.add_argument("-V", "--version", action="store_true")
    for lv in range(1, 8):
        p.add_argument(f"-{lv}", dest="level", action="store_const", const=lv)
    p.add_argument("-B", "--block-size", default="512K",
                   help="block size 4K..2M, power of two")
    p.add_argument("-T", "--threads", type=int, default=0)
    p.add_argument("-C", "--checksum", dest="checksum", action="store_true",
                   default=True)
    p.add_argument("-N", "--no-checksum", dest="checksum", action="store_false")
    p.add_argument("-D", "--dict", metavar="FILE")
    p.add_argument("-S", "--seekable", action="store_true")
    p.add_argument("-o", "--output", metavar="FILE")
    p.add_argument("-k", "--keep", action="store_true")
    p.add_argument("-f", "--force", action="store_true")
    p.add_argument("-c", "--stdout", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("-j", "--json", action="store_true")
    p.add_argument("--progress", choices=("auto", "always", "never"),
                   default="auto")
    p.add_argument("--device", action="store_true",
                   help="decode through the GPU batch path")
    p.add_argument("--hints", action="store_true",
                   help="compress: also write the <out>.zxh piece-plan "
                        "hint sidecar; decompress --device: use/create "
                        "<in>.zxh (first decode caches it)")
    p.add_argument("--dict-size", type=int, default=16384,
                   help="target dictionary size for --train")
    p.add_argument("files", nargs="*", metavar="FILE")
    return p


def parse_block_size(text: str) -> int:
    t = text.strip().upper()
    mult = 1
    if t.endswith("K"):
        mult, t = 1024, t[:-1]
    elif t.endswith("M"):
        mult, t = 1024 * 1024, t[:-1]
    try:
        size = int(t) * mult
        C.block_size_code(size)  # validates power-of-two and range
    except ValueError:
        raise ZxcError(-14, f"bad block size {text!r} (4K..2M, power of two)")
    return size


def _threads(n: int) -> int:
    """``-T``: 0 means every core."""
    return max(1, (os.cpu_count() or 1) if n == 0 else n)


def _load_dict(path: str | None) -> Dictionary | None:
    if not path:
        return None
    with open(path, "rb") as f:
        return Dictionary.load(f.read())


def _gather_inputs(args, log: Log) -> list[str]:
    files = list(args.files)
    if args.recursive:
        out = []
        for f in files:
            if os.path.isdir(f):
                for dirpath, _, names in sorted(os.walk(f)):
                    out += [os.path.join(dirpath, n) for n in sorted(names)]
            else:
                out.append(f)
        files = out
    files = [None if f == "-" else f for f in files]   # "-" = stdin
    for f in files:
        if f is not None and not os.path.exists(f):
            raise ZxcError(-11, f"no such file: {f}")
    return files


def _read(path: str | None) -> bytes:
    if path is None or path == "-":
        return sys.stdin.buffer.read()
    with open(path, "rb") as f:
        return f.read()


def _write(path: str | None, data: bytes, force: bool, log: Log):
    if path is None or path == "-":
        sys.stdout.buffer.write(data)
        sys.stdout.buffer.flush()
        return
    if os.path.exists(path) and not force:
        raise ZxcError(-11, f"output exists (use -f): {path}")
    with open(path, "wb") as f:
        f.write(data)


def dopts_for_hints(eopts: EncodeOpts) -> DecodeOpts:
    return DecodeOpts(checksum=False, dict_content=eopts.dict_content,
                      dict_huf=eopts.dict_huf)


def _decode(archive: bytes, opts: DecodeOpts, dev, threads: int = 1,
            hint_path: str | None = None) -> bytes:
    """``dev`` None: the native host decoder on ``threads`` threads; else
    the device paths on ``dev``."""
    if dev is not None:
        from . import ops
        if hint_path:
            # use the sidecar when valid; create it when absent (first
            # decode caches); a stale or foreign hint falls back to the
            # cold path. Only ZxcError: a kernel that fails to build or
            # launch raises RuntimeError, which must reach the caller.
            try:
                if not os.path.exists(hint_path):
                    ops.write_hints(archive, hint_path, opts)
                return ops.decompress_e2e(archive, opts, hint=hint_path,
                                          device=dev)
            except ZxcError:
                pass
        return ops.decompress(archive, opts, device=dev)
    return frame.decompress(archive, opts, threads=threads)


def cmd_compress(args, log: Log, dev=None) -> int:
    d = _load_dict(args.dict)
    eopts = EncodeOpts(level=args.level or C.LEVEL_DEFAULT,
                       block_size=parse_block_size(args.block_size),
                       checksum=args.checksum, seekable=args.seekable,
                       dict_content=d.content if d else None,
                       dict_huf=d.huf_lengths if d else None)
    files = _gather_inputs(args, log) or [None]
    if args.output and len(files) > 1:
        raise ZxcError(-12, "-o cannot combine with multiple inputs")
    for src in files:
        data = _read(src)
        t0 = time.time()
        prog = Progress(args.progress, len(data), src or "stdin")
        if dev is not None and d is None and not args.seekable:
            from . import ops
            # the JAX CLI's expression: -B defaults to 512K, so without
            # -B the blocks are 512 KiB and take the kernel-free matcher;
            # -B 64K (or smaller) selects the LCP and parse-walk kernels
            out = ops.compress_device(
                data, level=eopts.level,
                block_size=eopts.block_size or 65536,
                checksum=eopts.checksum, device=dev)
        elif args.threads != 1:
            # the native worker pool: the same archive at every count
            out = frame.compress(data, dataclasses.replace(
                eopts, threads=_threads(args.threads)))
        else:
            out = frame.compress(data, eopts)
        prog.update(len(data))
        prog.finish()
        dt = time.time() - t0
        if args.stdout or src is None:
            dst = None
        else:
            dst = args.output or (src + SUFFIX)
        _write(dst, out, args.force, log)
        if args.hints and dst is not None:
            from . import ops
            try:
                ops.write_hints(out, dst + ".zxh", dopts_for_hints(eopts))
                log.info(f"{dst}.zxh: piece-plan hints written")
            except ZxcError as e:  # hints are an optimization, not a gate
                log.info(f"hints skipped: {e}")
        ratio = len(out) / max(len(data), 1) * 100
        log.info(f"{src or 'stdin'}: {len(data)} -> {len(out)} bytes "
                 f"({ratio:.2f}%) in {dt:.3f}s")
        # auto-deletion applies only when the output name is auto-derived
        # (reference: -o keeps the input, tests/test_cli.sh section 28.1)
        if (src is not None and dst is not None and not args.keep
                and not args.output):
            os.unlink(src)
    return 0


def cmd_decompress(args, log: Log, dev=None) -> int:
    d = _load_dict(args.dict)
    dopts = DecodeOpts(checksum=args.checksum,
                       dict_content=d.content if d else None,
                       dict_huf=d.huf_lengths if d else None)
    threads = _threads(args.threads)
    # positional OUTPUT-FILE: `zxc -d INPUT OUTPUT` (reference
    # tests/test_cli.sh section 28.3) — two positionals where the second
    # does not exist and no -o/-m means the second names the output
    if (len(args.files) == 2 and not args.multiple and not args.output
            and os.path.exists(args.files[0])
            and not os.path.exists(args.files[1])):
        args.output = args.files.pop()
    files = _gather_inputs(args, log) or [None]
    if args.output and len(files) > 1:
        raise ZxcError(-12, "-o cannot combine with multiple inputs")
    for src in files:
        blob = _read(src)
        t0 = time.time()
        hp = (src + ".zxh") if (args.hints and src and dev is not None) \
            else None
        try:
            dsz = frame.get_decompressed_size(blob)
        except ZxcError:
            dsz = None
        prog = Progress(args.progress, dsz or 0, src or "stdin",
                        operation="Decompressing")
        out = _decode(blob, dopts, dev, threads, hp)
        prog.update(len(out))
        prog.finish()
        dt = time.time() - t0
        if args.stdout or src is None:
            dst = None
        elif args.output:
            dst = args.output
        elif src.endswith(SUFFIX):
            dst = src[:-len(SUFFIX)]
        else:
            raise ZxcError(-11, f"cannot derive output name for {src}")
        _write(dst, out, args.force, log)
        log.info(f"{src or 'stdin'}: {len(blob)} -> {len(out)} bytes in {dt:.3f}s")
        if (src is not None and dst is not None and not args.keep
                and not args.output):
            os.unlink(src)
    return 0


def cmd_list(args, log: Log) -> int:
    from .format import headers as H
    rc = 0
    for src in _gather_inputs(args, log):
        try:
            blob = _read(src)
            if (len(blob) >= 4
                    and int.from_bytes(blob[:4], "little") == C.DICT_MAGIC):
                d = Dictionary.load(blob)
                if args.json:
                    print(json.dumps({"file": src, "type": "dictionary",
                                      "id": f"0x{d.id:08x}",
                                      "content_bytes": len(d.content)}))
                else:
                    print(f"{src}: zxc dictionary, id=0x{d.id:08x}, "
                          f"content={len(d.content)} bytes, shared-table=yes")
                continue
            fh = H.read_file_header(blob)
            size, ghash = H.read_file_footer(blob)
            n_blocks = sum(1 for _ in frame.iter_blocks(blob))
            sek = H.parse_seek_table(blob)
        except (ZxcError, OSError) as e:
            # JSON list reports failing entries inline and exits nonzero
            # (reference tests/test_cli.sh "JSON list with a failing entry")
            if args.json:
                print(json.dumps({"file": src, "error": str(e)}))
            else:
                log.info(f"{src}: not a zxc archive ({e})")
            rc = 1
            continue
        if args.json:
            print(json.dumps({
                "file": src, "type": "archive",
                "format_version": C.FORMAT_VERSION,
                "block_size": fh.block_size, "blocks": n_blocks,
                "decompressed": size, "compressed": len(blob),
                "ratio_pct": round(len(blob) / max(size, 1) * 100, 2),
                "checksums": bool(fh.has_checksum),
                "global_hash": f"0x{ghash:08x}",
                "dict_id": f"0x{fh.dict_id:08x}" if fh.dict_id else None,
                "seekable": len(sek) if sek else 0}))
            continue
        print(f"{src}: zxc v{C.FORMAT_VERSION} archive")
        print(f"  block size:      {fh.block_size}")
        print(f"  blocks:          {n_blocks}")
        print(f"  decompressed:    {size} bytes")
        print(f"  compressed:      {len(blob)} bytes "
              f"({len(blob) / max(size, 1) * 100:.2f}%)")
        print(f"  checksums:       {'yes' if fh.has_checksum else 'no'}")
        print(f"  global hash:     0x{ghash:08x}")
        print(f"  dictionary id:   "
              f"{'0x%08x' % fh.dict_id if fh.dict_id else 'none'}")
        print(f"  seekable:        {'yes (%d entries)' % len(sek) if sek else 'no'}")
    return rc


def cmd_test(args, log: Log, dev=None) -> int:
    d = _load_dict(args.dict)
    dopts = DecodeOpts(checksum=True,
                       dict_content=d.content if d else None,
                       dict_huf=d.huf_lengths if d else None)
    rc = 0
    for src in _gather_inputs(args, log):
        try:
            out = _decode(_read(src), dopts, dev)
            log.info(f"{src}: OK ({len(out)} bytes)")
        except ZxcError as e:
            log.info(f"{src}: FAILED ({e})")
            rc = 1
    return rc


def cmd_bench(args, log: Log, dev=None) -> int:
    seconds = args.bench or 5
    d = _load_dict(args.dict)
    eopts = EncodeOpts(level=args.level or C.LEVEL_DEFAULT,
                       block_size=parse_block_size(args.block_size),
                       checksum=args.checksum,
                       dict_content=d.content if d else None,
                       dict_huf=d.huf_lengths if d else None)
    dopts = DecodeOpts(checksum=args.checksum,
                       dict_content=d.content if d else None,
                       dict_huf=d.huf_lengths if d else None)
    for src in _gather_inputs(args, log):
        data = _read(src)
        arc = frame.compress(data, eopts)
        # encode timing
        t0 = time.time()
        n = 0
        while time.time() - t0 < seconds / 2:
            frame.compress(data, eopts)
            n += 1
        enc_mbps = len(data) * n / (time.time() - t0) / 1e6
        t0 = time.time()
        n = 0
        while time.time() - t0 < seconds / 2:
            _decode(arc, dopts, dev)
            n += 1
        dec_mbps = len(data) * n / (time.time() - t0) / 1e6
        ratio = len(arc) / max(len(data), 1) * 100
        if args.json:
            print(json.dumps({
                "file": src, "level": eopts.level, "size": len(data),
                "compressed": len(arc), "ratio_pct": round(ratio, 2),
                "compress_mbps": round(enc_mbps, 2),
                "decompress_mbps": round(dec_mbps, 2)}))
        else:
            print(f"{src}: level -{eopts.level}  ratio {ratio:.2f}%  "
                  f"enc {enc_mbps:.1f} MB/s  dec {dec_mbps:.1f} MB/s")
    return 0


def cmd_train(args, log: Log) -> int:
    from .codec import dict_train
    files = _gather_inputs(args, log)
    if not files:
        raise ZxcError(-12, "training requires sample files")
    samples = [_read(f) for f in files]
    d = dict_train.dict_train(samples, args.dict_size)
    out = args.output or f"dictionary_{d.id:08x}.zxd"
    _write(out, d.save(), args.force, log)
    log.info(f"trained dictionary id=0x{d.id:08x} "
             f"({len(d.content)} bytes content) -> {out}")
    return 0


def main(argv: list[str] | None = None, *, device=None) -> int:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``); returns the exit
    code. ``device`` is the torch device of ``--device`` (None: cuda, which
    must be available; ``"cpu"``: the kernels' plain versions)."""
    args = _parser().parse_args(argv)
    # `unzxc` alias: invoked under that name, the default mode flips to
    # decompression (reference: unzxc symlink, tests/test_cli.sh)
    if (not args.decompress and not args.compress and not args.list
            and not args.test and args.bench is None and not args.train
            and os.path.basename(sys.argv[0] or "").startswith("unzxc")):
        args.decompress = True
    log = Log(args.verbose, args.quiet)
    if args.version:
        print(f"zxc {VERSION} (zxc_tpu_torch, format v{C.FORMAT_VERSION})")
        return 0
    dev = None
    if args.device and not (args.list or args.train):
        from .ops.device_pipeline import _device
        try:   # refuse before any input is read or output written
            dev = _device(device, "--device")
        except RuntimeError as e:
            print(f"zxc: {e}", file=sys.stderr)
            return 1
    try:
        if args.train:
            return cmd_train(args, log)
        if args.list:
            return cmd_list(args, log)
        if args.test:
            return cmd_test(args, log, dev)
        if args.bench is not None:
            return cmd_bench(args, log, dev)
        if args.decompress:
            return cmd_decompress(args, log, dev)
        return cmd_compress(args, log, dev)
    except ZxcError as e:
        print(f"zxc: {e}", file=sys.stderr)
        return 1
    except (OSError, BrokenPipeError) as e:
        print(f"zxc: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
