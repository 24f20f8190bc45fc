"""The route call's bytes: a key read (4 B) and a replica id written (4 B)
a key.  Whatever implements the call reads and writes at least these."""


def bytes_per_item(config: dict) -> int:
    return 4 + 4
