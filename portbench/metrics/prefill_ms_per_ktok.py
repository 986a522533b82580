"""prefill_ms_per_ktok: device milliseconds of the work that ran inside
the wrapper's prefill ranges of the traced slice, per 1000 prompt tokens
prefilled there."""


def read(run):
    sl = run.slice
    if sl is None:
        return None
    tokens = sum(c[4] * c[5] for c in sl.slice_calls("prefill"))
    busy = sl.range_device_s("prefill")
    return busy * 1e3 / (tokens / 1e3) if tokens and busy else None
