"""Expert CLI (vvencFFapp analog): VTM-style .cfg files + every option.

Usage:  python -m vvenc_tpu_torch.ffapp -c encoder.cfg [-c override.cfg ...]
                 [Key=Value ...]

Cfg syntax (vvenc cfg/*.cfg): one `Key : Value` per line, '#' comments.
Later files / command-line pairs override earlier ones.  Option names
follow the reference's cfg vocabulary (InputFile, Size, FrameRate, QP,
IntraPeriod, GOPSize, Preset, TargetBitrate, NumPasses, Threads, WPP,
tool flags by their vvenc names); unknown keys map onto the flat config
via the string-param API when possible.  The encoder runs on the card
(the easy app's --device, default cuda) unless a cfg file or pair asks
for the CPU (`Device : cpu`, through the string-param API).
"""

from __future__ import annotations

import sys

# vvenc cfg-file option name -> CLI argument of __main__ (None: special)
_OPTION_MAP = {
    "inputfile": "-i", "bitstreamfile": "-o", "reconfile": "--recon",
    "framerate": "-r", "framestobeencoded": "-f", "qp": "-q",
    "intraperiod": "--intra-period", "gopsize": "--gop-size",
    "preset": "--preset", "targetbitrate": "--bitrate",
    "numpasses": "--passes", "passes": "--passes",
    "rcstatsfile": "--rc-statsfile", "threads": "--threads",
    "inputbitdepth": "--input-bitdepth",
    "decodedpicturehash": "--picture-hash", "seidecodedpicturehash":
    "--picture-hash", "perceptqpa": "--qpa",
}
_FLAG_MAP = {"wpp": "--wpp", "verify": "--verify",
             "hrdparameterspresent": "--sei-timing"}
# vvenc tool names -> our flat-config string-param keys (via --set)
_SET_MAP = {
    "ctusize": "ctu_size", "minqtsize": "min_qt_size",
    "maxmttdepth": "max_mtt_depth", "maxmttdepthi": "max_mtt_depth_i",
    "alf": "alf", "ccalf": "ccalf", "sao": "sao",
    "loopfilterdisable": None, "deblockingfilterdisable": None,
    "depquant": "dep_quant", "signhideflag": "sign_data_hiding",
    "rdoq": "rdoq", "lfnst": "lfnst", "mts": "mts",
    "mtsimplicit": "mts_implicit", "mip": "mip", "isp": "isp",
    "mrl": "mrl", "lmchroma": "lm_chroma", "jointcbcr": "joint_cbcr",
    "affine": "affine", "prof": "prof", "sbtmvp": "sbtmvp",
    "bdof": "bdof", "dmvr": "dmvr", "mmvd": "mmvd", "smvd": "smvd",
    "geo": "geo", "ciip": "ciip", "sbt": "sbt", "bcw": "bcw",
    "amvr": "amvr", "imv": "amvr", "tmvp": "tmvp",
    "transformskip": "transform_skip", "bdpcm": "bdpcm",
    "mctf": "mctf", "ibc": "ibc", "dualitree": "dual_i_tree",
    "ifp": "ifp", "ifplines": "ifp_lines", "lookahead": "look_ahead",
}


def parse_cfg_file(path: str):
    """-> list of (key, value) in file order."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if ":" in line:
                k, _, v = line.partition(":")
            elif "=" in line:
                k, _, v = line.partition("=")
            else:
                continue
            out.append((k.strip(), v.strip()))
    return out


def cfg_to_argv(pairs):
    """Map (key, value) option pairs onto the easy-app argv."""
    argv = []
    size_w = size_h = None
    for k, v in pairs:
        lk = k.lower().replace("_", "")
        if lk in ("size",):
            argv += ["-s", v.lower()]
        elif lk == "sourcewidth":
            size_w = v
        elif lk == "sourceheight":
            size_h = v
        elif lk in ("loopfilterdisable", "deblockingfilterdisable"):
            argv += ["--set", f"deblocking={0 if int(v) else 1}"]
        elif lk in _OPTION_MAP:
            argv += [_OPTION_MAP[lk], v]
        elif lk in _FLAG_MAP:
            if str(v) not in ("0", "false", "False"):
                argv += [_FLAG_MAP[lk]]
        elif lk in _SET_MAP and _SET_MAP[lk]:
            argv += ["--set", f"{_SET_MAP[lk]}={v}"]
        else:
            # last resort: try the flat-config string-param API directly
            argv += ["--set", f"{k}={v}"]
    if size_w and size_h:
        argv += ["-s", f"{size_w}x{size_h}"]
    return argv


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    pairs = []
    rest = []
    i = 0
    while i < len(argv):
        if argv[i] in ("-c", "--config"):
            pairs += parse_cfg_file(argv[i + 1])
            i += 2
        elif "=" in argv[i] and not argv[i].startswith("-"):
            k, _, v = argv[i].partition("=")
            pairs.append((k, v))
            i += 1
        else:
            rest.append(argv[i])
            i += 1
    from .__main__ import main as easy_main
    return easy_main(cfg_to_argv(pairs) + rest)


if __name__ == "__main__":
    sys.exit(main())
