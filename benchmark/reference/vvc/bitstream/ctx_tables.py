"""CABAC context initialization data (ITU-T H.266 section 9.3.2.2).

Each context set maps to four rows: initValue for slice-type init IDs
B(0) / P(1) / I(2), plus a per-context log2-window-size (adaptation rate)
row.  These are normative tables of the VVC standard; values cross-checked
against the reference implementation (vvenc CommonLib/Contexts.cpp:200-868)
which encodes the identical standard tables.

The linear context numbering below (offset accumulation in REGISTRY order)
is our own; only (initValue, rate) per syntax-element context is normative.
"""

from __future__ import annotations

import numpy as np

CNU = 35  # "context not used" init value
DWS = 8   # default window size

# name -> [init_B, init_P, init_I, rates]
_T = {}

_T["SplitFlag"] = [
    [18, 27, 15, 18, 28, 45, 26, 7, 23],
    [11, 35, 53, 12, 6, 30, 13, 15, 31],
    [19, 28, 38, 27, 29, 38, 20, 30, 31],
    [12, 13, 8, 8, 13, 12, 5, 9, 9]]
_T["SplitQtFlag"] = [
    [26, 36, 38, 18, 34, 21],
    [20, 14, 23, 18, 19, 6],
    [27, 6, 15, 25, 19, 37],
    [0, 8, 8, 12, 12, 8]]
_T["SplitHvFlag"] = [
    [43, 42, 37, 42, 44],
    [43, 35, 37, 34, 52],
    [43, 42, 29, 27, 44],
    [9, 8, 9, 8, 5]]
_T["Split12Flag"] = [
    [28, 29, 28, 29],
    [43, 37, 21, 22],
    [36, 45, 36, 45],
    [12, 13, 12, 13]]
_T["ModeConsFlag"] = [
    [25, 20], [25, 12], [CNU, CNU], [1, 0]]
_T["SkipFlag"] = [
    [57, 60, 46], [57, 59, 45], [0, 26, 28], [5, 4, 8]]
_T["MergeFlag"] = [[6], [21], [26], [4]]
_T["RegularMergeFlag"] = [[46, 15], [38, 7], [CNU, CNU], [5, 5]]
_T["MergeIdx"] = [[18], [20], [34], [4]]
_T["MmvdFlag"] = [[25], [26], [CNU], [4]]
_T["MmvdMergeIdx"] = [[43], [43], [CNU], [10]]
_T["MmvdStepMvpIdx"] = [[59], [60], [CNU], [0]]
_T["SubblockMergeFlag"] = [
    [25, 58, 45], [48, 57, 44], [CNU, CNU, CNU], [4, 4, 4]]
_T["AffMergeIdx"] = [[4], [5], [CNU], [0]]
_T["CiipFlag"] = [[57], [57], [CNU], [1]]
_T["PredMode"] = [[40, 35], [40, 35], [CNU, CNU], [5, 1]]
_T["IntraLumaMpmFlag"] = [[44], [36], [45], [6]]
_T["IntraLumaPlanarFlag"] = [[13, 6], [12, 20], [13, 28], [1, 5]]
_T["MultiRefLineIdx"] = [[25, 59], [25, 58], [25, 60], [5, 8]]
_T["MipFlag"] = [
    [56, 57, 50, 26], [41, 57, 58, 26], [33, 49, 50, 25], [9, 10, 9, 6]]
_T["ISPMode"] = [[33, 43], [33, 36], [33, 43], [9, 2]]
_T["CclmModeFlag"] = [[26], [34], [59], [4]]
_T["CclmModeIdx"] = [[27], [27], [27], [9]]
_T["IntraChromaPredMode"] = [[25], [25], [34], [5]]
_T["DeltaQP"] = [[CNU, CNU], [CNU, CNU], [CNU, CNU], [DWS, DWS]]
_T["InterDir"] = [
    [14, 13, 5, 4, 3, 40], [7, 6, 5, 12, 4, 40],
    [CNU, CNU, CNU, CNU, CNU, CNU], [0, 0, 1, 4, 4, 0]]
_T["RefPic"] = [[5, 35], [20, 35], [CNU, CNU], [0, 4]]
_T["AffineFlag"] = [
    [19, 13, 6], [12, 13, 14], [CNU, CNU, CNU], [4, 0, 0]]
_T["AffineType"] = [[35], [35], [CNU], [4]]
_T["BcwIdx"] = [[5], [4], [CNU], [1]]
_T["Mvd"] = [[51, 36], [44, 43], [14, 45], [9, 5]]
_T["BDPCMMode"] = [
    [19, 21, 0, 28], [40, 36, 0, 13], [19, 35, 1, 27], [1, 4, 1, 0]]
_T["QtRootCbf"] = [[12], [5], [6], [4]]
_T["ACTFlag"] = [[CNU], [CNU], [CNU], [DWS]]
_T["QtCbfLuma"] = [
    [15, 6, 5, 14], [23, 5, 20, 7], [15, 12, 5, 7], [5, 1, 8, 9]]
_T["QtCbfCb"] = [[25, 37], [25, 28], [12, 21], [5, 0]]
_T["QtCbfCr"] = [
    [9, 36, 45], [25, 29, 45], [33, 28, 36], [2, 1, 0]]
_T["SigCoeffGroupLuma"] = [[25, 45], [25, 30], [18, 31], [8, 5]]
_T["SigCoeffGroupChroma"] = [[25, 14], [25, 45], [25, 15], [5, 8]]
_T["SigFlagLuma0"] = [
    [17, 41, 49, 36, 1, 49, 50, 37, 48, 51, 58, 45],
    [17, 41, 42, 29, 25, 49, 43, 37, 33, 58, 51, 30],
    [25, 19, 28, 14, 25, 20, 29, 30, 19, 37, 30, 38],
    [12, 9, 9, 10, 9, 9, 9, 10, 8, 8, 8, 10]]
_T["SigFlagChroma0"] = [
    [9, 49, 50, 36, 48, 59, 59, 38],
    [17, 34, 35, 21, 41, 59, 60, 38],
    [25, 27, 28, 37, 34, 53, 53, 46],
    [12, 12, 9, 13, 4, 5, 8, 9]]
_T["SigFlagLuma1"] = [
    [26, 45, 53, 46, 49, 54, 61, 39, 35, 39, 39, 39],
    [19, 38, 38, 46, 34, 54, 54, 39, 6, 39, 39, 39],
    [11, 38, 46, 54, 27, 39, 39, 39, 44, 39, 39, 39],
    [9, 13, 8, 8, 8, 8, 8, 5, 8, 0, 0, 0]]
_T["SigFlagChroma1"] = [
    [34, 45, 38, 31, 58, 39, 39, 39],
    [35, 45, 53, 54, 44, 39, 39, 39],
    [19, 46, 38, 39, 52, 39, 39, 39],
    [8, 12, 12, 8, 4, 0, 0, 0]]
_T["SigFlagLuma2"] = [
    [19, 54, 39, 39, 50, 39, 39, 39, 0, 39, 39, 39],
    [19, 39, 54, 39, 19, 39, 39, 39, 56, 39, 39, 39],
    [18, 39, 39, 39, 27, 39, 39, 39, 0, 39, 39, 39],
    [8, 8, 8, 8, 8, 0, 4, 4, 0, 0, 0, 0]]
_T["SigFlagChroma2"] = [
    [34, 38, 54, 39, 41, 39, 39, 39],
    [34, 38, 62, 39, 26, 39, 39, 39],
    [11, 39, 39, 39, 19, 39, 39, 39],
    [8, 8, 8, 8, 4, 0, 0, 0]]
_T["ParFlagLuma"] = [
    [33, 40, 25, 41, 26, 42, 25, 33, 26, 34, 27, 25, 41, 42, 42, 35, 33, 27, 35, 42, 43],
    [18, 17, 33, 18, 26, 42, 25, 33, 26, 42, 27, 25, 34, 42, 42, 35, 26, 27, 42, 20, 20],
    [33, 25, 18, 26, 34, 27, 25, 26, 19, 42, 35, 33, 19, 27, 35, 35, 34, 42, 20, 43, 20],
    [8, 9, 12, 13, 13, 13, 10, 13, 13, 13, 13, 13, 13, 13, 13, 13, 10, 13, 13, 13, 13]]
_T["ParFlagChroma"] = [
    [33, 25, 26, 34, 19, 27, 33, 42, 43, 35, 43],
    [25, 25, 26, 11, 19, 27, 33, 42, 35, 35, 43],
    [33, 25, 26, 42, 19, 27, 26, 50, 35, 20, 43],
    [8, 12, 12, 12, 13, 13, 13, 13, 13, 13, 13]]
_T["GtxFlagLuma0"] = [  # gt1 (greater-than-1), luma
    [25, 0, 0, 17, 25, 26, 0, 9, 25, 33, 19, 0, 25, 33, 26, 20, 25, 33, 27, 35, 22],
    [17, 0, 1, 17, 25, 18, 0, 9, 25, 33, 34, 9, 25, 18, 26, 20, 25, 18, 19, 27, 29],
    [25, 1, 40, 25, 33, 11, 17, 25, 25, 18, 4, 17, 33, 26, 19, 13, 33, 19, 20, 28, 22],
    [1, 5, 9, 9, 9, 6, 5, 9, 10, 10, 9, 9, 9, 9, 9, 9, 6, 8, 9, 9, 10]]
_T["GtxFlagChroma0"] = [
    [25, 1, 25, 33, 26, 12, 25, 33, 27, 28, 37],
    [17, 9, 25, 10, 18, 4, 17, 33, 19, 20, 29],
    [40, 9, 25, 18, 26, 35, 25, 26, 35, 28, 37],
    [1, 5, 8, 8, 9, 6, 6, 9, 8, 8, 9]]
_T["GtxFlagLuma1"] = [  # gt3 (greater-than-3), luma
    [0, 0, 33, 34, 35, 21, 25, 34, 35, 28, 29, 40, 42, 43, 29, 30, 49, 36, 37, 45, 38],
    [0, 17, 26, 19, 35, 21, 25, 34, 20, 28, 29, 33, 27, 28, 29, 22, 34, 28, 44, 37, 38],
    [25, 25, 11, 27, 20, 21, 33, 12, 28, 21, 22, 34, 28, 29, 29, 30, 36, 29, 45, 30, 23],
    [9, 5, 10, 13, 13, 10, 9, 10, 13, 13, 13, 9, 10, 10, 10, 13, 8, 9, 10, 10, 13]]
_T["GtxFlagChroma1"] = [
    [0, 40, 34, 43, 36, 37, 57, 52, 45, 38, 46],
    [0, 25, 19, 20, 13, 14, 57, 44, 30, 30, 23],
    [40, 33, 27, 28, 21, 37, 36, 37, 45, 38, 46],
    [8, 8, 9, 12, 12, 10, 5, 9, 9, 9, 13]]
_T["LastXLuma"] = [
    [6, 6, 12, 14, 6, 4, 14, 7, 6, 4, 29, 7, 6, 6, 12, 28, 7, 13, 13, 35],
    [6, 13, 12, 6, 6, 12, 14, 14, 13, 12, 29, 7, 6, 13, 36, 28, 14, 13, 5, 26],
    [13, 5, 4, 21, 14, 4, 6, 14, 21, 11, 14, 7, 14, 5, 11, 21, 30, 22, 13, 42],
    [8, 5, 4, 5, 4, 4, 5, 4, 1, 0, 4, 1, 0, 0, 0, 0, 1, 0, 0, 0]]
_T["LastXChroma"] = [
    [19, 5, 4], [12, 4, 18], [12, 4, 3], [5, 4, 4]]
_T["LastYLuma"] = [
    [5, 5, 20, 13, 13, 19, 21, 6, 12, 12, 14, 14, 5, 4, 12, 13, 7, 13, 12, 41],
    [5, 5, 12, 6, 6, 4, 6, 14, 5, 12, 14, 7, 13, 5, 13, 21, 14, 20, 12, 34],
    [13, 5, 4, 6, 13, 11, 14, 6, 5, 3, 14, 22, 6, 4, 3, 6, 22, 29, 20, 34],
    [8, 5, 8, 5, 5, 4, 5, 5, 4, 0, 5, 4, 1, 0, 0, 1, 4, 0, 0, 0]]
_T["LastYChroma"] = [
    [11, 5, 27], [11, 4, 18], [12, 4, 3], [6, 5, 5]]
_T["MVPIdx"] = [[34], [34], [42], [12]]
_T["SmvdFlag"] = [[28], [28], [CNU], [5]]
_T["SaoMergeFlag"] = [[2], [60], [60], [0]]
_T["SaoTypeIdx"] = [[2], [5], [13], [4]]
_T["LFNSTIdx"] = [
    [52, 37, 27], [37, 45, 27], [28, 52, 42], [9, 9, 10]]
_T["PLTFlag"] = [[17], [0], [25], [1]]
_T["TransformSkipFlag"] = [[25, 17], [25, 9], [25, 9], [1, 1]]
_T["MTSIdx"] = [
    [45, 25, 27, 0], [45, 40, 27, 0], [29, 0, 28, 0], [8, 0, 9, 0]]
_T["SbtFlag"] = [[41, 57], [56, 57], [CNU, CNU], [1, 5]]
_T["SbtQuadFlag"] = [[42], [42], [CNU], [10]]
_T["SbtHorFlag"] = [
    [35, 51, 27], [20, 43, 12], [CNU, CNU, CNU], [8, 4, 1]]
_T["SbtPosFlag"] = [[28], [28], [CNU], [13]]
_T["ChromaQpAdjFlag"] = [[CNU], [CNU], [CNU], [DWS]]
_T["ChromaQpAdjIdc"] = [[CNU], [CNU], [CNU], [DWS]]
_T["ImvFlag"] = [
    [59, 26, 50, 60, 38], [59, 48, 58, 60, 60],
    [CNU, 34, CNU, CNU, CNU], [0, 5, 0, 0, 4]]
_T["CtbAlfFlag"] = [
    [33, 52, 46, 25, 61, 54, 25, 61, 54],
    [13, 23, 46, 4, 61, 54, 19, 46, 54],
    [62, 39, 39, 54, 39, 39, 31, 39, 39],
    [0, 0, 0, 4, 0, 0, 1, 0, 0]]
_T["CtbAlfAlternative"] = [[11, 26], [20, 12], [11, 11], [0, 0]]
_T["AlfUseTemporalFilt"] = [[46], [46], [46], [0]]
_T["CcAlfFilterControlFlag"] = [
    [25, 35, 38, 25, 28, 38], [18, 21, 38, 18, 21, 38],
    [18, 30, 31, 18, 30, 31], [4, 1, 4, 4, 1, 4]]
_T["IBCFlag"] = [[0, 43, 45], [0, 57, 44], [17, 42, 36], [1, 5, 8]]
_T["JointCbCrFlag"] = [
    [42, 43, 52], [27, 36, 45], [12, 21, 35], [1, 1, 0]]
_T["TsSigCoeffGroup"] = [
    [18, 35, 45], [18, 12, 29], [18, 20, 38], [5, 8, 8]]
_T["TsSigFlag"] = [
    [25, 50, 37], [40, 35, 44], [25, 28, 38], [13, 13, 8]]
_T["TsParFlag"] = [[11], [3], [11], [6]]
_T["TsGtxFlag"] = [
    [CNU, 3, 4, 4, 5], [CNU, 2, 10, 3, 3], [CNU, 10, 3, 3, 3],
    [DWS, 1, 1, 1, 1]]
_T["TsLrg1Flag"] = [
    [19, 11, 4, 6], [18, 11, 4, 28], [11, 5, 5, 14], [4, 2, 1, 6]]
_T["TsResidualSign"] = [
    [35, 25, 46, 28, 33, 38], [5, 10, 53, 43, 25, 46],
    [12, 17, 46, 28, 25, 46], [1, 4, 4, 5, 8, 8]]


class CtxSet:
    """A named contiguous range of context indices."""

    __slots__ = ("name", "offset", "size")

    def __init__(self, name: str, offset: int, size: int):
        self.name, self.offset, self.size = name, offset, size

    def __call__(self, inc: int = 0) -> int:
        assert 0 <= inc < self.size, (self.name, inc, self.size)
        return self.offset + inc

    def __repr__(self):
        return f"CtxSet({self.name}, off={self.offset}, n={self.size})"


def _build():
    sets = {}
    init = [[], [], []]
    rates = []
    off = 0
    for name, rows in _T.items():
        n = len(rows[0])
        assert all(len(r) == n for r in rows), name
        sets[name] = CtxSet(name, off, n)
        for i in range(3):
            init[i].extend(rows[i])
        rates.extend(rows[3])
        off += n
    init_np = np.array(init, dtype=np.uint8)          # [3, num_ctx]
    rates_np = np.array(rates, dtype=np.uint8)        # [num_ctx]
    return sets, init_np, rates_np, off


CTX_SETS, INIT_VALUES, RATE_VALUES, NUM_CTX = _build()

# convenience grouped accessors matching syntax usage
SIG_FLAG = [CTX_SETS[f"SigFlag{c}{i}"] for i in range(3) for c in ("Luma", "Chroma")]
# order: [luma0, chroma0, luma1, chroma1, luma2, chroma2]
PAR_FLAG = [CTX_SETS["ParFlagLuma"], CTX_SETS["ParFlagChroma"]]
GTX_FLAG = [CTX_SETS["GtxFlagLuma0"], CTX_SETS["GtxFlagChroma0"],
            CTX_SETS["GtxFlagLuma1"], CTX_SETS["GtxFlagChroma1"]]
LAST_X = [CTX_SETS["LastXLuma"], CTX_SETS["LastXChroma"]]
LAST_Y = [CTX_SETS["LastYLuma"], CTX_SETS["LastYChroma"]]
SIG_COEFF_GROUP = [CTX_SETS["SigCoeffGroupLuma"], CTX_SETS["SigCoeffGroupChroma"]]
QT_CBF = [CTX_SETS["QtCbfLuma"], CTX_SETS["QtCbfCb"], CTX_SETS["QtCbfCr"]]
