"""Cohort selection: sample names by gender and (super-)population.

Reference behavior (backend/get_sample_names.py:5-45): SQL over the
``samples`` table — ``gender IN <gends> AND (super_pop IN <pops> OR
pop IN <pops>)``, with the ``('ALL',)`` sentinel skipping the population
filter; the OR-of-INs dedups super/sub-population overlap.  This version
uses parameterized SQL (the reference interpolates strings,
get_sample_names.py:17-31 — a quirk SURVEY.md §7.0(5) says not to keep)
but returns the same names in the same table order.
"""

from __future__ import annotations

import sqlite3


def get_sample_names(gend_names, pop_names, intgen_convdb_path: str) -> list:
    if isinstance(gend_names, str) or isinstance(pop_names, str):
        # tuple('male') == ('m','a','l','e') would silently match nothing
        raise TypeError(
            "gend_names/pop_names must be sequences of names, not a "
            "bare string"
        )
    gend_names = tuple(gend_names)
    pop_names = tuple(pop_names)
    query = (
        "SELECT sample FROM samples WHERE gender IN "
        f"({', '.join('?' for _ in gend_names)})"
    )
    params = list(gend_names)
    if pop_names != ("ALL",):
        marks = ", ".join("?" for _ in pop_names)
        query += f" AND (super_pop IN ({marks}) OR pop IN ({marks}))"
        params += list(pop_names) * 2
    with sqlite3.connect(intgen_convdb_path) as conn:
        cursor = conn.cursor()
        sample_names = [row[0] for row in cursor.execute(query, params)]
        cursor.close()
    return sample_names
