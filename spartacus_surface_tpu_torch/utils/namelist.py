"""Minimal Fortran-namelist reader.

Parses the subset of Fortran namelist syntax used by the reference's config
files (test/*/config.nam): groups ``&name ... /``, scalar assignments with
Fortran logical/integer/real/string literals, and ``!`` comments.

Parity: replaces the Fortran namelist reads in
radsurf/radsurf_config.F90:125-247 and
driver/spartacus_surface_config.F90:76-165.

A copy of spartacus_surface_tpu/utils/namelist.py (plain Python, no JAX):
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import re


def _parse_value(text: str):
    text = text.strip()
    low = text.lower()
    if low in (".true.", "t", ".t.", "true"):
        return True
    if low in (".false.", "f", ".f.", "false"):
        return False
    if text.startswith(("'", '"')) and text.endswith(("'", '"')) and len(text) >= 2:
        return text[1:-1]
    # Fortran reals may use d/D exponents
    num = text.replace("d", "e").replace("D", "e")
    try:
        return int(num)
    except ValueError:
        pass
    try:
        return float(num)
    except ValueError:
        pass
    # Comma-separated array
    if "," in text:
        return [_parse_value(v) for v in text.split(",") if v.strip()]
    return text


def read_namelists(path: str) -> dict:
    """Read a namelist file, returning {group_name: {key: value}}.

    Keys are lower-cased. Later groups with the same name are merged
    (later keys win), matching how a sequential namelist read behaves.
    """
    with open(path) as f:
        content = f.read()

    groups: dict = {}
    # Strip comments (a '!' outside of quotes starts a comment)
    lines = []
    for line in content.splitlines():
        out, in_quote = [], None
        for ch in line:
            if in_quote:
                out.append(ch)
                if ch == in_quote:
                    in_quote = None
            elif ch in "'\"":
                in_quote = ch
                out.append(ch)
            elif ch == "!":
                break
            else:
                out.append(ch)
        lines.append("".join(out))
    content = "\n".join(lines)

    for m in re.finditer(r"&(\w+)(.*?)(?:^|\s)/", content, re.S):
        name = m.group(1).lower()
        body = m.group(2)
        group = groups.setdefault(name, {})
        for am in re.finditer(r"([\w%()]+)\s*=\s*([^=\n]+?)(?=(?:[\w%()]+\s*=)|$|\n)", body):
            key = am.group(1).strip().lower()
            group[key] = _parse_value(am.group(2).strip().rstrip(","))
    return groups
