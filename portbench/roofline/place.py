"""The place call's bytes: a key read (4 B), ``r`` replica ids written
(4 B each) and the exhausted flag written (1 B) a key.  Whatever
implements the call reads and writes at least these."""


def bytes_per_item(config: dict) -> int:
    return 4 + 4 * config["r"] + 1
