"""Color palettes and plane maps for plotting (the port's own copy of
``scrubvae_tpu/plot/constants.py``)."""

PALETTE_DICT = {
    0: "#FF1F5B",
    1: "#00CD6C",
    2: "#009ADE",
    3: "#AF58BA",
    4: "#FFC61E",
    5: "#F28522",
    6: "#A0B1BA",
    7: "#A6761D",
    8: "#0D4A70",
    9: "#06592A",
    10: "#191919",
}

PALETTE_2 = [
    "#e60049",
    "#0bb4ff",
    "#50e991",
    "#e6d800",
    "#9b19f5",
    "#ffa300",
    "#dc0ab4",
    "#b3d4ff",
    "#00bfa0",
    "#b30000",
    "#7c1158",
    "#4421af",
    "#000000",
    "#7393B3",
]

PLANE = {"x": 0, "y": 1, "z": 2}
