"""Training rows of every epoch the window completed over the time from
the window's start to the end of its last epoch (host clock; an epoch is
the shuffle, the steps, validation and the trainer's one host sync)."""


def read(record):
    if record["driver"] != "train":
        return None
    return record["epochs"] * record["train_rows"] / record["window_s"]
