"""Order ``permutation``: one permutation of the inputs drawn from the seed."""

from lz4bench import traffic


def order(n: int, mix: dict, seed: int) -> list[int]:
    return traffic.rng(seed, "order").permutation(n).tolist()
