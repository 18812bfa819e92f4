"""Device milliseconds a step inside the benchmark's range around the
port's ``AdamW.update`` (the union of the device work launched in it)."""


def read(record):
    t = record.get("trace")
    if record["mode"] != "train" or not t:
        return None
    n = t["span_counts"].get("pkbench.optimizer", 0)
    if not n:
        return None
    return 1e3 * t["spans"]["pkbench.optimizer"] / n
