"""The share of the traced slice in which no kernel, copy or fill ran on
the card, in percent (pipeline cells)."""


def read(record):
    tr = record.get("trace")
    if record["driver"] != "pipeline" or tr is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["seconds"])
