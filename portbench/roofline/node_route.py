"""The node route's bytes: a group's key read (4 B), its ``r`` rack columns
read (4 B each) and its ``r`` DataNode ids written (4 B each), 76 B at
r = 9.  Whatever computes the node level reads and writes at least these."""


def bytes_per_item(config: dict) -> int:
    return 4 + 4 * config["r"] + 4 * config["r"]
