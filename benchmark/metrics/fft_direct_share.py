"""fft_direct_share: the share of the dense engine's 3-D transforms that
went through the program's own cuFFT plans, from the counts each record's
timings hold (fft_direct: through the plans, fft_torch: through
torch.fft): the direct transforms over all of them, summed over the
window's records.  None where no record carries the counts (a program
without them, the out-of-core engine) or where they sum to 0."""


def read(run):
    direct = total = 0
    seen = False
    for rec in run["records"]:
        t = rec["timings"]
        if t.get("fft_direct") is None or t.get("fft_torch") is None:
            continue
        seen = True
        direct += t["fft_direct"]
        total += t["fft_direct"] + t["fft_torch"]
    return direct / total if seen and total > 0 else None
