"""pinned_reuse_share: the share of the page-locked bytes handed out over
the window that came from the program's pool of idle blocks, from its
process totals kernels.HOST_COUNTS["pinned_reuse"]["bytes"] and
["pinned_alloc"]["bytes"], which each record's timings hold from the join
of its hand-off as pinned_reuse_bytes_total and pinned_alloc_bytes_total:
the reused bytes' growth over the reused and allocated bytes' growth, from
the first record to the last.  None with one record, with nothing handed
out between them, or from a program without the pool's counter."""


def read(run):
    recs = run["records"]
    if len(recs) < 2:
        return None
    first, last = recs[0]["timings"], recs[-1]["timings"]
    keys = ("pinned_reuse_bytes_total", "pinned_alloc_bytes_total")
    if any(t.get(k) is None for t in (first, last) for k in keys):
        return None
    reused = last[keys[0]] - first[keys[0]]
    total = reused + last[keys[1]] - first[keys[1]]
    return reused / total if total > 0 else None
