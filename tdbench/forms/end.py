"""Form ``end``: ``token`` after every text."""


def apply(texts: list[str], form: dict, seed: int) -> list[str]:
    return [t + form["token"] for t in texts]
