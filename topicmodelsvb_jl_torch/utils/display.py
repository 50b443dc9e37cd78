"""Terminal display helpers.

The reference renders all ``show*`` output with colored "Julia dots"
via Crayons (macros.jl:3-25).  Same look here with raw ANSI codes,
auto-disabled when stdout is not a TTY.  A copy of the JAX package's
``utils/display.py``.
"""

from __future__ import annotations

import sys

RED = "\x1b[1;31m"
GREEN = "\x1b[1;32m"
BLUE = "\x1b[1;34m"
YELLOW = "\x1b[1;33m"
WHITE_BOLD = "\x1b[1;37m"
RESET = "\x1b[0m"


def _color_enabled() -> bool:
    return hasattr(sys.stdout, "isatty") and sys.stdout.isatty()


def juliadots(text: str) -> None:
    """Print ``●●●`` dots then bold text (reference @juliadots, macros.jl:3-25)."""
    if _color_enabled():
        sys.stdout.write(f" {RED}●{GREEN}●{BLUE}● {WHITE_BOLD}{text}{RESET}")
    else:
        sys.stdout.write(f" ●●● {text}")
    sys.stdout.flush()


def bullet(text: str) -> None:
    """Yellow ``•`` bullet line (reference showtitles style, Corpus.jl:225)."""
    if _color_enabled():
        print(f" {YELLOW}•{RESET} {text}")
    else:
        print(f" • {text}")
