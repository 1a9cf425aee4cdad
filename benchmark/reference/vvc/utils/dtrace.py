"""Rule-based debug trace channels (vvenc CDTrace analog, dtrace.h:109).

Channels are named streams (D_HEADER, D_CABAC, D_SYNTAX, D_REC_CB_LUMA,
D_QP, D_MOT_FIELD, ...) gated by rules parsed from a condition string of
the reference's form:

    "D_CABAC:poc==8" or "D_SYNTAX:poc>=2,final==1"

A rule activates its channel only when every condition matches the
current context (set via ctx update calls from the encode/decode loops).
Configure from the environment:

    VVENC_TPU_TRACE_RULE="D_CABAC:poc==0"  VVENC_TPU_TRACE_FILE=/tmp/t.txt

or programmatically with DTRACE.configure(rule, path).  Zero overhead
when unconfigured (enabled-flag fast path, like the compile-gated
reference macros)."""

from __future__ import annotations

import os
import re
import sys

CHANNELS = ("D_HEADER", "D_NALUNITHEADER", "D_CABAC", "D_SYNTAX",
            "D_REC_CB_LUMA", "D_REC_CB_CHROMA", "D_QP", "D_MOT_FIELD",
            "D_RDCOST", "D_BEST_MODE", "D_MODE_COST")


class DTrace:
    def __init__(self):
        self.enabled = False
        self._rules = {}       # channel -> [(key, op, value), ...]
        self._ctx = {"poc": -1, "final": 0, "ctu": -1}
        self._out = None

    def configure(self, rule: str | None, path: str | None = None) -> None:
        """rule: "CH:cond,cond;CH2:..." with conds like poc==N / poc>=N."""
        self._rules.clear()
        self._out = open(path, "w") if path else None
        if not rule:
            self.enabled = False
            return
        for part in rule.split(";"):
            part = part.strip()
            if not part:
                continue
            ch, _, conds = part.partition(":")
            lst = []
            for c in conds.split(","):
                m = re.match(r"\s*(\w+)\s*(==|>=|<=|>|<|!=)\s*(-?\d+)", c)
                if m:
                    lst.append((m.group(1), m.group(2), int(m.group(3))))
            self._rules[ch.strip()] = lst
        self.enabled = bool(self._rules)

    def update_ctx(self, **kv) -> None:
        if self.enabled:
            self._ctx.update(kv)

    def _match(self, channel: str) -> bool:
        conds = self._rules.get(channel)
        if conds is None:
            return False
        for key, op, val in conds:
            cur = self._ctx.get(key, 0)
            ok = {"==": cur == val, "!=": cur != val, ">=": cur >= val,
                  "<=": cur <= val, ">": cur > val, "<": cur < val}[op]
            if not ok:
                return False
        return True

    def trace(self, channel: str, fmt: str, *args) -> None:
        if not self.enabled or not self._match(channel):
            return
        text = (fmt % args) if args else fmt
        out = self._out or sys.stdout
        out.write(text if text.endswith("\n") else text + "\n")

    def flush(self) -> None:
        if self._out:
            self._out.flush()


DTRACE = DTrace()
_rule = os.environ.get("VVENC_TPU_TRACE_RULE")
if _rule:
    DTRACE.configure(_rule, os.environ.get("VVENC_TPU_TRACE_FILE"))
