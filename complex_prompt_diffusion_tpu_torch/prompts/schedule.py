"""Scheduled / alternating prompt grammar ("prompt editing").

Counterpart of ``complex_prompt_diffusion_tpu/prompts/schedule.py``, the
AUTOMATIC1111-style syntax:

  * ``[a:b:0.5]`` — render "a" for the first half of the steps, then "b"
    (a bare number >= 1 is an absolute step; < 1 is a fraction of steps)
  * ``[a:10]``    — introduce "a" at step 10; ``[a::10]`` removes it there
  * ``[a|b]``     — alternate between variants every step
  * ``(x:1.2)`` / ``[x]`` — emphasis brackets pass through unchanged

The JAX package parses this grammar with lark's Earley parser::

    !start: (prompt | /[][():]/+)*
    prompt: (emphasized | scheduled | alternate | plain | WHITESPACE)*
    !emphasized: "(" prompt ")" | "(" prompt ":" prompt ")" | "[" prompt "]"
    scheduled: "[" [prompt ":"] prompt ":" [WHITESPACE] NUMBER "]"
    alternate: "[" prompt ("|" prompt)+ "]"
    WHITESPACE: /\\s+/
    plain: /([^\\\\\\[\\]():|]|\\\\.)+/
    NUMBER: SIGNED_NUMBER

The port has no lark: :class:`_Parser` is a recursive-descent parser of the
same grammar that picks the derivation lark's ambiguity resolution picks.
Inside a bracket construct the grammar is unambiguous but for one choice
that the rendering can see (below); at the top level a bracket that opens a
well-formed construct is parsed as one and anything else is a literal
bracket token, which is what lark resolves to. Every construct's content
is forced: a prompt runs to the next ``:``, ``|``, ``]`` or ``)``, and its
plain runs and whitespace runs are maximal, as lark's dynamic lexer matches
them.

The rendering keeps the JAX package's generator semantics, quirks
included, because they decide the text:

  * an alternate renders only the *first item* of its chosen option: a
    plain run whole, a leading whitespace token or emphasis bracket as one
    character, a scheduled or alternate construct whole. An option that
    starts with whitespace followed by text is one plain run (lark's
    choice), so ``[ a|b]`` renders " a" at step 1;
  * a scheduled construct's number becomes ``min(steps, int(when))``
    (``when`` scaled by ``steps`` first if below 1), so a negative number
    gives a negative boundary: ``[a:b:-1]`` at 4 steps is
    ``[[-4, 'a'], [4, 'b']]``;
  * input that does not parse (a ``|`` outside an alternate, a trailing
    backslash) degrades to one constant entry;
  * an alternate whose chosen option is empty (``[a|]``) makes the JAX
    package raise lark's ``VisitError`` while rendering; the port raises
    ValueError there, at the same steps.

``expand_schedule(prompt, steps)`` returns ``[[until_step, text], ...]`` —
the prompt text in effect up to (and including) each boundary step.
"""

from __future__ import annotations

import re
from typing import List, Optional

__all__ = ["expand_schedule", "get_prompt_sequence"]

# lark's terminals, as its grammar compiles them
_PLAIN = re.compile(r"([^\\\[\]():|]|\\.)+")
_WS = re.compile(r"\s+")
_NUMBER = re.compile(
    r"(?:(?:\+|\-))?(?:(?:(?:[0-9])+(?:e|E)(?:(?:\+|\-))?(?:[0-9])+|(?:(?:[0-9])+\.(?:(?:[0-9])+)?"
    r"|\.(?:[0-9])+)(?:(?:e|E)(?:(?:\+|\-))?(?:[0-9])+)?)|(?:[0-9])+)"
)
_RAW = "[]():"  # the start rule's literal bracket tokens


class _Node:
    """A parse-tree node: ``data`` is the rule's name; ``children`` are
    nodes, token strings or None (an absent optional part)."""

    __slots__ = ("data", "children")

    def __init__(self, data: str, children: list):
        self.data = data
        self.children = children


class _Plain(str):
    """A plain run (lark's ``plain`` rule over one token)."""


class _ParseError(Exception):
    pass


class _Parser:
    def __init__(self, text: str):
        self.s = text
        self.n = len(text)

    def _match(self, pat, i: int) -> Optional[int]:
        m = pat.match(self.s, i)
        return m.end() if m and m.end() > i else None

    def prompt(self, i: int):
        """The prompt from ``i`` to the first character no item can start
        with; returns (node, end)."""
        items = []
        s = self.s
        while i < self.n:
            c = s[i]
            if c in "[(":
                got = self.construct(i)
                if got is None:
                    break
                node, i = got
                items.append(node)
                continue
            if c in "]):|":
                break
            end = self._match(_PLAIN, i)
            if end is None:
                break
            # one maximal plain run, leading whitespace included (lark's
            # choice for an option's first item; later items render whole
            # however lark splits them)
            items.append(_Plain(s[i:end]))
            i = end
        return _Node("prompt", items), i

    def construct(self, i: int):
        """The emphasized, scheduled or alternate construct opening at
        ``i``, or None if none is well formed there."""
        s = self.s
        open_ = s[i]
        p1, j = self.prompt(i + 1)
        if j >= self.n:
            return None
        if open_ == "(":
            if s[j] == ")":
                return _Node("emphasized", ["(", p1, ")"]), j + 1
            if s[j] == ":":
                p2, k = self.prompt(j + 1)
                if k < self.n and s[k] == ")":
                    return _Node("emphasized", ["(", p1, ":", p2, ")"]), k + 1
            return None
        if s[j] == "]":
            return _Node("emphasized", ["[", p1, "]"]), j + 1
        if s[j] == "|":
            options = [p1]
            while j < self.n and s[j] == "|":
                p, j = self.prompt(j + 1)
                options.append(p)
            if j < self.n and s[j] == "]":
                return _Node("alternate", options), j + 1
            return None
        if s[j] == ":":
            tail = self.number_tail(j + 1)
            if tail is not None:  # "[" prompt ":" [WS] NUMBER "]"
                ws, num, end = tail
                return _Node("scheduled", [None, p1, ws, num]), end
            p2, k = self.prompt(j + 1)
            if k < self.n and s[k] == ":":
                tail = self.number_tail(k + 1)
                if tail is not None:
                    ws, num, end = tail
                    return _Node("scheduled", [p1, p2, ws, num]), end
        return None

    def number_tail(self, i: int):
        """``[WHITESPACE] NUMBER "]"`` from ``i``: (ws or None, number
        text, end) or None."""
        ws = None
        w = self._match(_WS, i)
        if w is not None:
            ws, i = self.s[i:w], w
        e = self._match(_NUMBER, i)
        if e is None or e >= self.n or self.s[e] != "]":
            return None
        return ws, self.s[i:e], e + 1

    def start(self) -> _Node:
        """The top level: constructs where they are well formed, literal
        bracket tokens elsewhere, plain and whitespace runs between."""
        s, i, items = self.s, 0, []
        while i < self.n:
            c = s[i]
            if c in "[(":
                got = self.construct(i)
                if got is not None:
                    node, i = got
                    items.append(node)
                    continue
            if c in _RAW:
                items.append(c)
                i += 1
                continue
            end = self._match(_PLAIN, i)
            if end is None:  # "|" outside an alternate, a trailing backslash
                raise _ParseError(f"unexpected {c!r} at {i}")
            items.append(_Plain(s[i:end]))
            i = end
        return _Node("start", items)


def _nodes(node):
    yield node
    for ch in node.children:
        if isinstance(ch, _Node):
            yield from _nodes(ch)


def _boundaries(tree: _Node, steps: int) -> List[int]:
    """All step indices at which the rendered text changes; each scheduled
    node's number becomes its boundary, as the JAX package rewrites it."""
    found = [steps]
    for node in _nodes(tree):
        if node.data == "scheduled":
            when = float(node.children[-1])
            if when < 1:
                when *= steps
            node.children[-1] = min(steps, int(when))
            found.append(node.children[-1])
        elif node.data == "alternate":
            found.extend(range(1, steps + 1))
    return sorted(set(found))


_EMPTY = object()


def _render_at(tree: _Node, step: int) -> str:
    def item(x):
        if isinstance(x, _Plain):
            return plain(x)
        return rule(x) if isinstance(x, _Node) else x

    def plain(x):
        yield str(x)

    def rule(node):
        args = [item(c) for c in node.children]
        if node.data == "scheduled":
            return scheduled(*args)
        if node.data == "alternate":
            return alternate(args)
        return default(args)

    def scheduled(before, after, _ws, when):
        yield (before or ()) if step <= when else after

    def alternate(args):
        got = next(args[(step - 1) % len(args)], _EMPTY)
        if got is _EMPTY:
            raise ValueError(f"alternate option {(step - 1) % len(args)} is empty at step {step}")
        yield got

    def default(children):
        for child in children:
            yield from child

    def flatten(x):
        if isinstance(x, str):
            yield x
        else:
            for it in x:
                yield from flatten(it)

    return "".join(flatten([item(c) for c in tree.children]))


def expand_schedule(prompt: str, steps: int) -> List[List]:
    """One prompt -> [[until_step, text], ...]. Input that does not parse
    (e.g. a ``|`` outside brackets) degrades to a single constant entry;
    an alternate that renders an empty option raises ValueError."""
    try:
        tree = _Parser(prompt).start()
    except _ParseError:
        return [[steps, prompt]]
    return [[t, _render_at(tree, t)] for t in _boundaries(tree, steps)]


def get_prompt_sequence(prompts: List[str], steps: int) -> List[List[List]]:
    """Batch version over a list of prompts (memoized per unique prompt)."""
    cache = {p: expand_schedule(p, steps) for p in set(prompts)}
    return [cache[p] for p in prompts]
