"""Parser for boost::property_tree .info files.

The reference configures everything through .info files
(tests/data/hierarchy_input.info, read at test_hierarchy.cc:208).  This
parser accepts the same syntax — nested braces, quoted keys/values, ';'
comments — and returns nested dicts consumable by Config.from_dict, so a user
can point mfmg_torch at an existing mfmg input file.  A copy of
mfmg_tpu/utils/info_parser.py (pure Python).

Supported subset: key value pairs, quoted strings, nested { } blocks,
comments starting with ';'.  (boost #include directives are not supported.)
"""

from __future__ import annotations

import re


def _tokenize(text: str):
    for line in text.splitlines():
        line = line.split(";", 1)[0].strip()
        if not line:
            continue
        # split into quoted strings, braces, and bare words
        for tok in re.findall(r'"[^"]*"|\{|\}|[^\s{}]+', line):
            yield tok


def _unquote(tok: str) -> str:
    if len(tok) >= 2 and tok[0] == '"' and tok[-1] == '"':
        return tok[1:-1]
    return tok


def parse_info(text: str) -> dict:
    """Parse .info content into nested dicts (values are strings)."""
    tokens = list(_tokenize(text))
    pos = 0

    def parse_block():
        nonlocal pos
        out = {}
        pending_key = None
        while pos < len(tokens):
            tok = tokens[pos]
            if tok == "}":
                pos += 1
                return out
            if tok == "{":
                pos += 1
                sub = parse_block()
                if pending_key is None:
                    raise ValueError("block without a key")
                out[pending_key] = sub
                pending_key = None
                continue
            key = _unquote(tok)
            pos += 1
            # value may be a string, a block on a following token, or empty
            if pos < len(tokens) and tokens[pos] not in ("{", "}"):
                nxt = tokens[pos]
                # peek: if the token after is "{", then `key nxt` was actually
                # two separate keys? boost treats "key value" then "{...}"
                # as value + child; we treat: key value (scalar)
                out[key] = _unquote(nxt)
                pos += 1
                if pos < len(tokens) and tokens[pos] == "{":
                    pos += 1
                    out[key] = parse_block()  # value was actually a stray
            else:
                pending_key = key
        return out

    return parse_block()


def load_info(path: str) -> dict:
    with open(path) as f:
        return parse_info(f.read())
