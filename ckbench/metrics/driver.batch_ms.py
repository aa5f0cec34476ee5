"""driver.batch_ms: mean host ms of the decode call that ``decode_split``
makes for a batch (the benchmark's span around the ``decode_fn`` it hands
over), over the window's batches."""


def read(r):
    if not r.batch_call_s:
        return None
    return 1e3 * sum(r.batch_call_s) / len(r.batch_call_s)
