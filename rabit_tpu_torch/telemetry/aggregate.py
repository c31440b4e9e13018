"""Fleet-wide aggregation of per-rank telemetry summaries: the port's
own copy of ``rabit_tpu/telemetry/aggregate.py``.

The tracker collects one ``telemetry_summary`` document per rank
(shipped through the wire protocol's ``metrics`` command) and merges
them here into a ``rabit_tpu.telemetry_fleet/v1`` document plus a
printable end-of-run table. Stdlib-only: the tracker imports it without
torch.
"""

from __future__ import annotations

from .schema import make_header, matches

FLEET_KIND = "telemetry_fleet"

_KEY_FIELDS = ("name", "op", "method", "wire", "bucket", "provenance")


def _row_key(row: dict):
    return tuple(row.get(k, "") for k in _KEY_FIELDS)


def merge_summaries(summaries: dict) -> dict:
    """Merge ``{rank_or_task_id: summary_doc}`` into one fleet doc.

    Counter rows with the same (name, op, method, wire, bucket,
    provenance) key sum their count/bytes/total_s and max their max_s;
    the log2-µs histograms add bucket-wise.
    """
    merged: dict = {}
    ranks = []
    recorded = dropped = 0
    for tid in sorted(summaries, key=str):
        doc = summaries[tid]
        if not matches(doc, "telemetry_summary"):
            continue
        ranks.append(doc.get("rank", tid))
        recorded += doc.get("recorded", 0)
        dropped += doc.get("dropped", 0)
        for row in doc.get("counters", []):
            key = _row_key(row)
            m = merged.get(key)
            if m is None:
                m = merged[key] = {k: row.get(k, "") for k in _KEY_FIELDS}
                m.update(count=0, bytes=0, total_s=0.0, max_s=0.0,
                         hist_log2_us={})
            m["count"] += row.get("count", 0)
            m["bytes"] += row.get("bytes", 0)
            m["total_s"] += row.get("total_s", 0.0)
            m["max_s"] = max(m["max_s"], row.get("max_s", 0.0))
            for b, n in row.get("hist_log2_us", {}).items():
                m["hist_log2_us"][b] = m["hist_log2_us"].get(b, 0) + n
    doc = make_header(FLEET_KIND)
    doc["ranks"] = ranks
    doc["num_ranks"] = len(ranks)
    doc["recorded"] = recorded
    doc["dropped"] = dropped
    doc["counters"] = [merged[k] for k in sorted(merged)]
    return doc


def format_fleet_table(fleet: dict) -> str:
    """Fixed-width end-of-run table the tracker prints (and tests
    grep). One line per counter key, fleet-summed."""
    lines = [
        f"telemetry: {fleet['num_ranks']} rank(s), "
        f"{fleet['recorded']} span(s), {fleet['dropped']} dropped",
        f"{'name':<22} {'op':<6} {'method':<7} {'wire':<5} "
        f"{'bucket':<10} {'count':>7} {'bytes':>12} {'total_s':>9} "
        f"{'max_s':>9}",
    ]
    for row in fleet.get("counters", []):
        lines.append(
            f"{row['name']:<22} {row['op'] or '-':<6} "
            f"{row['method'] or '-':<7} {row['wire'] or '-':<5} "
            f"{row['bucket']:<10} {row['count']:>7} {row['bytes']:>12} "
            f"{row['total_s']:>9.4f} {row['max_s']:>9.4f}")
    return "\n".join(lines)
