"""RU/EN interface-language detection for the entry scripts.

The reference switches its argparse help by OS locale via
``locale.getdefaultlocale()[0][:2] == 'ru'`` (reference ld_area.py:316-319
and siblings).  ``getdefaultlocale`` is deprecated since Python 3.11 and
removed in 3.13, so this helper reads the same environment variables the
old function consulted (plus ``locale.getlocale`` as a fallback) without
touching the deprecated API.
"""

from __future__ import annotations

import locale
import os


def ui_language() -> str:
    """'ru' when the user's locale is Russian, else 'en'."""
    lang = None
    for var in ("LANGUAGE", "LC_ALL", "LC_MESSAGES", "LANG"):
        val = os.environ.get(var)
        if val and val not in ("C", "POSIX"):
            lang = val
            break
    if not lang:
        try:
            lang = locale.getlocale()[0]
        except ValueError:
            lang = None
    return "ru" if (lang or "").lower().startswith("ru") else "en"
