"""Objects ``members``: each member of the corpus whole, in the corpus's order."""


def make(corpus: dict[str, bytes], mix: dict, seed: int) -> list[tuple[str, bytes]]:
    return list(corpus.items())
