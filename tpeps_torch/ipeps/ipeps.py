"""iPEPS state container and JSON state IO (counterpart of the
``IPEPS`` / ``read_ipeps`` / ``write_ipeps`` subset of tpeps/ipeps/ipeps.py).

On-site tensor convention ``a[s, u, l, d, r]``: physical index first,
auxiliary indices up/left/down/right anti-clockwise starting from up.
The JSON files are the reference's ``_state.json`` formats, read and
written by :mod:`tpeps_torch.io.tensor_io`.
"""

from __future__ import annotations

import json
from collections import OrderedDict

import numpy as np
import torch

from ..io.tensor_io import (
    read_json_tensor,
    serialize_bare_tensor_legacy,
    serialize_bare_tensor_np,
)


def from_pattern(pattern):
    """Build the (x,y) -> label map from a rectangular pattern."""
    lY, lX = len(pattern), len(pattern[0])
    site2index = {}
    for y in range(lY):
        if len(pattern[y]) != lX:
            raise ValueError("pattern is not rectangular")
        for x in range(lX):
            site2index[(x, y)] = pattern[y][x]
    return site2index


class IPEPS:
    """iPEPS over a rectangular unit cell: ``sites`` maps coord -> tensor."""

    def __init__(self, sites=None, vertexToSite=None, pattern=None, lX=None, lY=None):
        self.sites = OrderedDict(sites) if sites else OrderedDict()
        if pattern:
            self.lX, self.lY = len(pattern[0]), len(pattern)
        elif (lX is None or lY is None) and self.sites:
            xs = [c[0] for c in self.sites]
            ys = [c[1] for c in self.sites]
            self.lX = max(xs) - min(xs) + 1
            self.lY = max(ys) - min(ys) + 1
        elif lX and lY:
            self.lX, self.lY = lX, lY
        else:
            raise ValueError("lX and lY must be set directly or via sites/pattern")

        if vertexToSite is not None:
            self.vertexToSite = vertexToSite
        elif pattern:
            site2index = from_pattern(pattern)
            label2coord = {site2index[c]: c for c in self.sites}
            self.vertexToSite = lambda coord: label2coord[
                site2index[(coord[0] % self.lX, coord[1] % self.lY)]
            ]
        else:
            self.vertexToSite = lambda coord: (coord[0] % self.lX, coord[1] % self.lY)

    def site(self, coord=(0, 0)):
        return self.sites[self.vertexToSite(coord)]


def read_ipeps(jsonfile, vertexToSite=None, aux_seq=(0, 1, 2, 3), cls=IPEPS,
               dtype=None, device="cuda"):
    """Read a peps-torch JSON state.  ``aux_seq`` gives the order of the
    auxiliary indices in the file relative to [up, left, down, right].
    Tensors keep the file's dtype (float64 / complex128) unless ``dtype``
    is given."""
    asq = [x + 1 for x in aux_seq]
    sites = OrderedDict()
    with open(jsonfile) as j:
        raw_state = json.load(j)
    if "aux_ind_seq" in raw_state:
        asq = [x + 1 for x in raw_state["aux_ind_seq"]]
    for ts in raw_state["map"]:
        coord = (ts["x"], ts["y"])
        t = None
        for s in raw_state["sites"]:
            if s["siteId"] == ts["siteId"]:
                t = s
        if t is None:
            raise KeyError(f'Tensor with siteId {ts["siteId"]} not found in "sites"')
        X = np.ascontiguousarray(read_json_tensor(t).transpose(0, *asq))
        sites[coord] = torch.as_tensor(X, dtype=dtype, device=device)
    lX = raw_state["sizeM"] if "sizeM" in raw_state else raw_state["lX"]
    lY = raw_state["sizeN"] if "sizeN" in raw_state else raw_state["lY"]
    pattern = raw_state.get("pattern") if vertexToSite is None else None
    return cls(sites, vertexToSite=vertexToSite, pattern=pattern, lX=lX, lY=lY)


def write_ipeps(state, outputfile, aux_seq=(0, 1, 2, 3), tol=1.0e-14, normalize=False,
                fmt="legacy"):
    """Write a state in the reference JSON format."""
    asq = [x + 1 for x in aux_seq]
    json_state = {"lX": state.lX, "lY": state.lY, "sites": []}
    site_ids = []
    site_map = []
    for nid, (coord, site) in enumerate(state.sites.items()):
        site = site.detach().cpu().numpy()
        if normalize:
            site = site / np.abs(site).max()
        site_ids.append(f"A{nid}")
        site_map.append({"siteId": site_ids[-1], "x": coord[0], "y": coord[1]})
        site_t = site.transpose(0, *asq)
        if fmt == "legacy":
            json_tensor = serialize_bare_tensor_legacy(site_t, tol=tol)
        else:
            json_tensor = serialize_bare_tensor_np(site_t)
        json_tensor["siteId"] = site_ids[-1]
        json_state["sites"].append(json_tensor)
    json_state["siteIds"] = site_ids
    json_state["map"] = site_map
    ucoord_to_id = {(row["x"], row["y"]): row["siteId"] for row in site_map}
    json_state["pattern"] = [
        [ucoord_to_id[state.vertexToSite((x, y))] for x in range(state.lX)]
        for y in range(state.lY)
    ]
    with open(outputfile, "w") as f:
        json.dump(json_state, f, indent=4, separators=(",", ": "))
