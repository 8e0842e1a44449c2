"""Call ``encode``: ``Tokenizer.encode(text, allowed_special="all")``, one
text a unit."""


def texts(unit: str) -> list[str]:
    return [unit]


def bind(program):
    def call(unit: str) -> list[int]:
        return program.encode(unit, allowed_special="all")
    return call


def expected(ref, unit: str) -> list[int]:
    return ref.encode(unit)


def n_ids(out: list[int]) -> int:
    return len(out)
