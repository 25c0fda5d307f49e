"""Journal record envelope — ``ai4e_tpu/taskstore/journal.py``, byte for
byte: a journal written by either package replays in the other.

- **Envelope.** Every line the journaled store writes is
  ``J1:<crc32c>:<chain>:<payload JSON>``: the CRC-32C (Castagnoli) of the
  payload bytes, and a digest chained from the previous record's
  (``chain_n = crc32c(chain_{n-1} || crc_n)``, genesis ``00000000``). The
  checksum finds bit-rot and short writes at the record; the chain finds a
  dropped, reordered or spliced record, and two stores holding the same
  bytes hold the same chain head.
- **Legacy lines.** A line without ``J1:`` is a checksum-less record of a
  pre-envelope journal: it replays verbatim, and the chain still advances
  over its raw bytes.
- **Salvage, not skip.** A failing FINAL line is a torn tail (a crash
  mid-write): ``salvage`` truncates the file to the last verified record
  before any append handle opens, and writes a ``.salvage.json`` sidecar.
  A failing line with records after it is interior corruption, and the
  store refuses to open (``JournalCorruptError`` with the byte offset).
- ``parse_fsync_policy`` reads ``AI4E_TASKSTORE_FSYNC``: ``never`` (the
  default), ``always`` or ``group:<ms>``.

``python -m ai4e_tpu_torch.taskstore.journal <path> [...]`` verifies
journals offline: a verdict a file, record counts and the chain head.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

# Chain value before any record — also the chain head of an empty journal.
GENESIS = "00000000"

ENVELOPE_PREFIX = "J1:"
# "J1:" + 8 hex crc + ":" + 8 hex chain + ":" → payload starts at 21.
_PAYLOAD_AT = 21

_HEX = frozenset("0123456789abcdef")


def _crc32c_table() -> list[int]:
    poly = 0x82F63B78  # CRC-32C (Castagnoli), reflected
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


_TABLE = _crc32c_table()


def _crc32c_py(data: bytes) -> int:
    """The table loop: the reference form of the checksum, and what runs
    where the native one cannot be built."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# The native checksum (``native/crc32c.cpp``), bound at the first call:
# [function], or [None] when the toolchain cannot build it.
_NATIVE: list = []


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the value of JAX's table loop. A land-cover
    record holds its tile twice as hex (about 800 KB), which the loop in
    Python checksums in about 0.25 s under the store lock and again at
    every replay and absorb, so the native build (the SSE4.2 instruction)
    runs it, built at first use like the wire codecs; where it cannot be
    built the loop does, with the same value."""
    if not _NATIVE:
        import ctypes

        from ..utils.native_build import load_native_function
        _NATIVE.append(load_native_function(
            "crc32c.cpp", "libcrc32c.so", "ai4e_crc32c", ctypes.c_uint32,
            [ctypes.c_char_p, ctypes.c_uint64]))
    fn = _NATIVE[0]
    if fn is None:
        return _crc32c_py(data)
    return fn(data, len(data))


def crc32c_impl() -> str:
    """Which checksum runs in this process, ``"native"`` or ``"python
    loop"`` (the build is tried here if it was not yet): the control plane's
    startup line names it, since the loop is about a hundred times slower
    at replay."""
    crc32c(b"")
    return "native" if _NATIVE[0] is not None else "python loop"


def chain_next(prev_chain: str, crc_hex: str) -> str:
    """Advance the chain over one record: digest of the previous chain
    value concatenated with this record's checksum. Any dropped,
    reordered, or substituted record changes every chain value after it."""
    return f"{crc32c((prev_chain + crc_hex).encode('ascii')):08x}"


class JournalCorruptError(RuntimeError):
    """A journal record failed checksum/chain verification somewhere a
    silent skip would fork history — an interior record on open, or a
    replicated line mid-stream. Carries the byte ``offset`` (own-file
    scans) or ``line_no`` so the operator can find the record
    (docs/durability.md#corrupt-journal-runbook)."""

    def __init__(self, message: str, offset: int | None = None,
                 line_no: int | None = None, reason: str = "checksum"):
        super().__init__(message)
        self.offset = offset
        self.line_no = line_no
        self.reason = reason


def encode_record(rec: dict, prev_chain: str) -> tuple[str, str]:
    """Serialize one record into its enveloped line (no trailing newline);
    returns ``(line, new_chain)``."""
    payload = json.dumps(rec)
    crc_hex = f"{crc32c(payload.encode('utf-8')):08x}"
    chain = chain_next(prev_chain, crc_hex)
    return f"{ENVELOPE_PREFIX}{crc_hex}:{chain}:{payload}", chain


def verify_line(line: str, prev_chain: str | None
                ) -> tuple[dict, str | None, bool]:
    """Verify + decode ONE journal line (stripped, no newline).

    Returns ``(payload_record, new_chain, legacy)``. ``prev_chain=None``
    means chain continuity is unknown (a follower that attached
    mid-stream): the checksum is still verified and the line's own chain
    value is adopted. Raises ``JournalCorruptError`` on any mismatch or
    unparseable payload — the caller decides whether the failure is a
    salvageable tail or a quarantined interior record."""
    if not line.startswith(ENVELOPE_PREFIX):
        # Legacy checksum-less record (pre-envelope journal): accepted for
        # migration; the chain advances over the raw bytes so the head
        # stays comparable across stores holding the same file.
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as exc:
            raise JournalCorruptError(
                f"unparseable legacy journal line: {exc}",
                reason="legacy-json") from exc
        if not isinstance(rec, dict):
            raise JournalCorruptError(
                "legacy journal line is not a JSON object",
                reason="legacy-json")
        crc_hex = f"{crc32c(line.encode('utf-8')):08x}"
        # With an unknown predecessor a legacy line cannot anchor the
        # chain (it carries no chain value of its own) — stay unanchored.
        chain = (chain_next(prev_chain, crc_hex)
                 if prev_chain is not None else None)
        return rec, chain, True
    crc_hex = line[3:11]
    chain_hex = line[12:20]
    if (len(line) < _PAYLOAD_AT or line[11] != ":" or line[20] != ":"
            or not _HEX.issuperset(crc_hex)
            or not _HEX.issuperset(chain_hex)):
        raise JournalCorruptError("malformed journal envelope",
                                  reason="envelope")
    payload = line[_PAYLOAD_AT:]
    actual = f"{crc32c(payload.encode('utf-8')):08x}"
    if actual != crc_hex:
        raise JournalCorruptError(
            f"journal record checksum mismatch (stored {crc_hex}, "
            f"computed {actual})", reason="checksum")
    if prev_chain is not None:
        expect = chain_next(prev_chain, crc_hex)
        if expect != chain_hex:
            raise JournalCorruptError(
                f"journal chain broken (stored {chain_hex}, expected "
                f"{expect}) — a record before this one was dropped or "
                "substituted", reason="chain")
    try:
        rec = json.loads(payload)
    except json.JSONDecodeError as exc:
        raise JournalCorruptError(
            f"journal payload checksums clean but fails JSON parse: {exc}",
            reason="json") from exc
    return rec, chain_hex, False


@dataclass
class ScanResult:
    """One verification pass over a journal file."""
    records: int = 0
    legacy_records: int = 0
    good_bytes: int = 0          # end offset of the last verified record
    chain_head: str = GENESIS
    # Set when verification failed: byte offset + 1-based line number of
    # the failing record, why, and whether anything follows it.
    bad_offset: int | None = None
    bad_line_no: int | None = None
    bad_reason: str | None = None
    tail_bytes: int = 0          # bytes from bad_offset to EOF
    interior: bool = False       # a later line exists → NOT salvageable
    decoded: list[dict] = field(default_factory=list, repr=False)

    @property
    def clean(self) -> bool:
        return self.bad_offset is None


def scan_journal(path: str, keep_records: bool = False) -> ScanResult:
    """Verify every record + the chain, without applying anything.

    Stops at the first failure and classifies it: a failing FINAL line
    (including an unterminated trailing fragment) is a torn tail — the
    mid-write crash shape ``salvage`` truncates; a failing line with any
    non-empty line after it is interior corruption (``interior=True``)."""
    out = ScanResult()
    with open(path, "rb") as fh:
        data = fh.read()
    offset = 0
    line_no = 0
    n = len(data)
    while offset < n:
        nl = data.find(b"\n", offset)
        end = n if nl == -1 else nl + 1
        raw = data[offset:end]
        line_no += 1
        stripped = raw.strip()
        if not stripped:
            out.good_bytes = end
            offset = end
            continue
        failure: JournalCorruptError | None = None
        if nl == -1:
            # Unterminated trailing fragment: torn by definition — even a
            # fragment that happens to parse must not be trusted (the
            # crash interrupted its write; more bytes were coming).
            failure = JournalCorruptError(
                "unterminated final journal line", reason="torn")
        else:
            try:
                rec, chain, legacy = verify_line(
                    stripped.decode("utf-8", errors="strict"),
                    out.chain_head)
            except (JournalCorruptError, UnicodeDecodeError) as exc:
                failure = (exc if isinstance(exc, JournalCorruptError)
                           else JournalCorruptError(
                               f"undecodable journal bytes: {exc}",
                               reason="encoding"))
        if failure is not None:
            out.bad_offset = offset
            out.bad_line_no = line_no
            out.bad_reason = failure.reason
            out.tail_bytes = n - offset
            # Anything non-empty AFTER the failing line means replay
            # would have to skip a record mid-history — quarantine.
            out.interior = bool(data[end:].strip())
            return out
        out.records += 1
        out.legacy_records += int(legacy)
        out.chain_head = chain
        out.good_bytes = end
        if keep_records:
            out.decoded.append(rec)
        offset = end
    return out


@dataclass
class SalvageReport:
    path: str
    truncated_at: int
    dropped_bytes: int
    reason: str
    records_kept: int
    chain_head: str

    def to_dict(self) -> dict:
        return {"path": self.path, "truncated_at": self.truncated_at,
                "dropped_bytes": self.dropped_bytes, "reason": self.reason,
                "records_kept": self.records_kept,
                "chain_head": self.chain_head}


def salvage(path: str, scan: ScanResult | None = None
            ) -> SalvageReport | None:
    """Repair a torn tail in place — BEFORE any append handle opens.

    Returns None when the journal is clean. On a torn final record:
    truncates the file to the end of the last verified record (an
    ``"a"``-mode handle opened afterwards can never concatenate onto torn
    bytes — the exact bug a skip-only replay fix leaves behind), writes a
    ``<path>.salvage.json`` sidecar so the drop is auditable, and returns
    the report. On interior corruption: raises ``JournalCorruptError``
    with the offset — never a silent skip that forks history."""
    if scan is None:
        scan = scan_journal(path)
    if scan.clean:
        return None
    if scan.interior:
        raise JournalCorruptError(
            f"journal {path!r} has a corrupt INTERIOR record at byte "
            f"offset {scan.bad_offset} (line {scan.bad_line_no}, "
            f"{scan.bad_reason}); refusing to replay past it — a silent "
            "skip would fork history. Recover from a replica, or follow "
            "docs/durability.md#corrupt-journal-runbook "
            "(inspect with `python -m ai4e_tpu_torch.taskstore.journal "
            f"{path}`)",
            offset=scan.bad_offset, line_no=scan.bad_line_no,
            reason=scan.bad_reason or "checksum")
    report = SalvageReport(
        path=path, truncated_at=scan.good_bytes,
        dropped_bytes=scan.tail_bytes,
        reason=scan.bad_reason or "torn",
        records_kept=scan.records, chain_head=scan.chain_head)
    with open(path, "rb+") as fh:
        fh.truncate(scan.good_bytes)
    try:
        import time
        report_path = path + ".salvage.json"
        doc = dict(report.to_dict(), ts=time.time())
        with open(report_path, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=1)
    except OSError:
        # The truncation (the correctness half) already happened; a
        # failed audit sidecar must not block boot.
        import logging
        logging.getLogger("ai4e_tpu_torch.taskstore").exception(
            "could not write salvage report beside %s", path)
    return report


# -- fsync policy ------------------------------------------------------------

# AI4E_TASKSTORE_FSYNC (docs/durability.md): how hard an acknowledged
# append is pushed toward the platter before the caller unblocks.
#   never      — write+flush only (the page cache); survives process
#                SIGKILL, loses the unsynced tail on a machine crash.
#                Today's behavior, the default.
#   always     — fsync per append; an acknowledged mutation survives a
#                machine crash.
#   group:<ms> — group commit: at most one fsync per window, piggybacked
#                on appends and completed by a timer, so the crash
#                window is bounded by <ms> while the fsync cost
#                amortizes over every append in the window.
FSYNC_ENV = "AI4E_TASKSTORE_FSYNC"


def parse_fsync_policy(raw: str | None) -> tuple[str, float]:
    """``(kind, group_interval_s)``; raises ValueError loudly on junk so a
    typo'd policy fails at construction, not as silent data loss."""
    if raw is None:
        raw = os.environ.get(FSYNC_ENV, "") or "never"
    value = raw.strip().lower()
    if value in ("", "never"):
        return "never", 0.0
    if value == "always":
        return "always", 0.0
    if value.startswith("group:"):
        try:
            ms = float(value[len("group:"):])
        except ValueError:
            ms = -1.0
        # NOT `ms <= 0`: NaN compares False both ways and inf parses —
        # either would construct a store whose group fsync silently
        # never fires (the exact silent data loss this parser exists to
        # refuse).
        if not (0 < ms < float("inf")):
            raise ValueError(
                f"bad fsync policy {raw!r}: group:<ms> needs a positive "
                "finite millisecond window (e.g. group:20)")
        return "group", ms / 1000.0
    raise ValueError(
        f"bad fsync policy {raw!r}; expected never | always | group:<ms> "
        f"({FSYNC_ENV})")


# -- offline verification CLI ------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    """``python -m ai4e_tpu_torch.taskstore.journal <path> [...]`` — verify
    journals offline: per-file verdict, record/legacy counts, chain head,
    and the exact offset of the first bad record. Exit 1 on any corrupt
    file (torn tails report salvageable and exit 0 — boot repairs them)."""
    import sys
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m ai4e_tpu_torch.taskstore.journal "
              "<journal-path> [...]", file=sys.stderr)
        return 2
    rc = 0
    for path in argv:
        try:
            scan = scan_journal(path)
        except OSError as exc:
            print(f"{path}: unreadable ({exc})")
            rc = 1
            continue
        if scan.clean:
            print(f"{path}: OK — {scan.records} records "
                  f"({scan.legacy_records} legacy), "
                  f"chain head {scan.chain_head}")
        elif not scan.interior:
            print(f"{path}: TORN TAIL at byte {scan.bad_offset} "
                  f"(line {scan.bad_line_no}, {scan.bad_reason}); "
                  f"{scan.records} records verified, salvage will drop "
                  f"{scan.tail_bytes} bytes — boot repairs this")
        else:
            print(f"{path}: CORRUPT interior record at byte "
                  f"{scan.bad_offset} (line {scan.bad_line_no}, "
                  f"{scan.bad_reason}); {scan.records} records verified "
                  "before it — see "
                  "docs/durability.md#corrupt-journal-runbook")
            rc = 1
    return rc


if __name__ == "__main__":  # pragma: no cover - exercised via main()
    raise SystemExit(main())
