"""The Han script for the reference pretokenizer (``pretok``), frozen.

``HAN`` is the Han script (``\\p{Han}``) as inclusive ranges of code
points: those that the ``regex`` package (2026.7.19) holds in ``\\p{Han}``
and that Python 3.12's ``unicodedata`` (Unicode 15.0.0) assigns, i.e.
gives a category other than Cn. It was made with

    [cp for cp in range(0x110000)
     if unicodedata.category(chr(cp)) != "Cn"
     and regex.match(r"\\p{Han}", chr(cp))]

and written out as runs. tiktoken (0.13.0), whose Rust engine runs the
published patterns, holds exactly the same code points among those that
Unicode 15.0 assigns: it reads ``\\p{Han}`` as the Script property, not
Script_Extensions, so CJK punctuation such as U+3001 and U+300C stays out
(``tests/test_tdbench_pretok_scripts.py`` checks both engines). Code
points that an engine calls Han but Unicode 15.0 leaves unassigned
(``regex``: 4,943, in later CJK extensions; tiktoken: 622, Extension I)
are in no class here, as ``unicodedata`` has them, so that every class of
the reference rests on one Unicode version. 98,408 code points: Lo 98,060
(of them 70,004 above U+FFFF), So 329 (the radicals), Nl 13, Lm 3, Mc 2
and Po 1. The reference imports neither ``regex`` nor tiktoken; the card
may lack them.
"""

HAN = (
    (0x2E80, 0x2E99),
    (0x2E9B, 0x2EF3),
    (0x2F00, 0x2FD5),
    (0x3005, 0x3005),
    (0x3007, 0x3007),
    (0x3021, 0x3029),
    (0x3038, 0x303B),
    (0x3400, 0x4DBF),
    (0x4E00, 0x9FFF),
    (0xF900, 0xFA6D),
    (0xFA70, 0xFAD9),
    (0x16FE2, 0x16FE3),
    (0x16FF0, 0x16FF1),
    (0x20000, 0x2A6DF),
    (0x2A700, 0x2B739),
    (0x2B740, 0x2B81D),
    (0x2B820, 0x2CEA1),
    (0x2CEB0, 0x2EBE0),
    (0x2F800, 0x2FA1D),
    (0x30000, 0x3134A),
    (0x31350, 0x323AF),
)
