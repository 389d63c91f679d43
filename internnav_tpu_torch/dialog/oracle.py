"""Path-description oracle for the VL-LN dialog NPC.

Reference parity: internnav/habitat_extensions/vlln/simple_npc/
get_description.py — the NPC's actual knowledge. Given the shortest
navigable path from the agent to the goal plus MP3D scene annotations
(region polygons + object metadata), the oracle synthesizes a numbered,
step-by-step natural-language route description:

- room identification by point-in-polygon over region annotations
  (get_description.py:129-211),
- nearest-object assignment per waypoint (:515-557),
- passed-objects/regions + room-transition detection (:560-613),
- sharp-turn detection with signed angles (:651-686),
- phrase assembly (`get_path_description`, :383-468; plain fallback
  `get_path_description_without_additional_info`, :277-380),
- initial heading phrasing (`get_start_description`, :212-237) via
  yaw-rotation-to-first-waypoint (`compute_yaw_rotation`, :689-717).

This re-implementation is dependency-light (numpy only — no matplotlib,
no numpy-quaternion): polygon containment is a vectorized even-odd ray
cast, and quaternion→rotation is inlined. Phrase tables are data shared
with the reference (required for output parity). All randomness goes
through an injectable `choice` callable (default `np.random.choice`) so
tests and serving can pin it.

The `get_description` entry point mirrors
internnav/habitat_extensions/vlln/utils/dialog_utils.py:45-81: shortest
path from the agent to the closest reachable goal viewpoint, truncated to
the first ~4 m, deduplicated, described from the agent's current yaw.

Copy of internnav_tpu/dialog/oracle.py, kept in the port so that it imports
nothing of the JAX package (held equal to it by tests/test_torch_dialog.py).
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

Choice = Callable[[Sequence[str]], str]

# --------------------------------------------------------------------------
# Phrase tables (data; identical strings to the reference by necessity —
# get_description.py:8-126). Grouped in one dict rather than module globals.
# --------------------------------------------------------------------------
PHRASES: Dict[str, List[str]] = {
    "go_into_room": [
        "enter the {room}", "go into the {room}", "step into the {room}",
        "move into the {room}", "access the {room}",
        "obtain access to the {room}", "make your way into the {room}",
        "proceed into the {room}", "get into the {room}",
        "walk into the {room}", "step inside the {room}",
        "head into the {room}", "go inside the {room}",
    ],
    "turn_back": [
        "turn back", "make a back turn", "take a back turn", "turn around",
    ],
    "turn_angle": [
        "turn {turn} about {angle} degrees",
        "make about {angle} degrees {turn} turn",
        "take about {angle} degrees {turn} turn",
        "steer to {turn} about {angle} degrees",
        "change direction to about {angle} degrees {turn}",
        "navigate about {angle} degrees {turn}",
        "execute about {angle} degrees {turn}",
        "adjust your heading to {turn} about {angle} degrees",
        "hook about {angle} degrees {turn}",
        "steer {turn} about {angle} degrees",
    ],
    "turn": [
        "turn {turn}", "make a {turn} turn", "take a {turn} turn",
        "steer to {turn}", "change direction to {turn}",
        "navigate a {turn} turn", "execute a {turn} turn",
        "adjust your heading to {turn}", "hook a {turn}", "steer {turn}",
    ],
    "forward": [
        "move forward", "go forward", "walk forward", "step forward",
        "proceed forward", "advance forward", "make your way forward",
        "continue ahead", "keep going forward", "progress forward",
        "keep on going", "go ahead", "trek on", "head straight",
        "go straight ahead", "keep moving forward",
    ],
    "go_stairs": [
        "go {direction}stairs", "walk {direction}stairs",
        "climb {direction} the stairs", "take the stairs {direction}",
        "move {direction}stairs", "proceed {direction}stairs",
        "make your way {direction}stairs", "get {direction}stairs",
        "step {direction}stairs", "hop {direction}stairs",
        "run {direction} the stairs", "go {direction} to the next floor",
    ],
    "conjunction": [
        "and then", "then", "after that", "afterwards", "thereafter",
        "and next",
    ],
    "preposition": [
        "at the {object}", "beside the {object}", "near the {object}",
        "when see the {object}",
    ],
}

ROOM_NAMES = {
    "living region": "living room",
    "stair region": "stairs",
    "bathing region": "bathroom",
    "storage region": "storage room",
    "study region": "study room",
    "cooking region": "kitchen",
    "sports region": "sports room",
    "corridor region": "corridor",
    "toliet region": "toilet",
    "dinning region": "dining room",
    "resting region": "resting room",
    "open area region": "open area",
    "other region": "area",
}


def room_name(room: str) -> str:
    """MP3D region label → natural name (get_description.py:193-209)."""
    return ROOM_NAMES[room]


# --------------------------------------------------------------------------
# Geometry primitives
# --------------------------------------------------------------------------
def point_in_polygon(points: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Vectorized even-odd ray cast: (N, 2) points vs (V, 2) polygon.

    Replaces the reference's matplotlib.path.Path.contains_points
    (get_description.py:129-137) without the matplotlib dependency.
    """
    pts = np.atleast_2d(np.asarray(points, np.float64))
    poly = np.asarray(poly, np.float64)
    x, y = pts[:, 0:1], pts[:, 1:2]          # (N, 1)
    x0, y0 = poly[:, 0], poly[:, 1]          # (V,)
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    # edge straddles the horizontal ray through y
    straddle = (y0 <= y) != (y1 <= y)        # (N, V)
    with np.errstate(divide="ignore", invalid="ignore"):
        x_cross = x0 + (y - y0) * (x1 - x0) / np.where(y1 == y0, 1.0, y1 - y0)
    hits = straddle & (x < x_cross)
    return hits.sum(axis=1) % 2 == 1


def quat_from_yaw(yaw: float) -> np.ndarray:
    """(w, x, y, z) quaternion for a rotation of `yaw` about +Y — what
    quaternion.from_euler_angles([0, yaw, 0]) produces in the reference
    (dialog_utils.py:68)."""
    return np.asarray([math.cos(yaw / 2.0), 0.0, math.sin(yaw / 2.0), 0.0])


def _rotation_matrix(quat_wxyz: np.ndarray) -> np.ndarray:
    w, x, y, z = np.asarray(quat_wxyz, np.float64)
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0 else 2.0 / n
    return np.asarray([
        [1 - s * (y * y + z * z), s * (x * y - w * z), s * (x * z + w * y)],
        [s * (x * y + w * z), 1 - s * (x * x + z * z), s * (y * z - w * x)],
        [s * (x * z - w * y), s * (y * z + w * x), 1 - s * (x * x + y * y)],
    ])


def yaw_rotation_to(rotation, current_pos, target_pos) -> float:
    """Signed yaw (degrees, + = left) from the agent's facing direction to
    the direction of `target_pos` (get_description.py:689-717).

    `rotation` may be a habitat yaw float (about +Y), a (w, x, y, z)
    quaternion array, or a unit forward 3-vector.
    """
    direction = np.asarray(target_pos, np.float64) - np.asarray(current_pos, np.float64)
    direction[1] = 0
    direction = direction / np.linalg.norm(direction)
    if np.isscalar(rotation) or np.ndim(rotation) == 0:
        rotation = quat_from_yaw(float(rotation))
    rotation = np.asarray(rotation, np.float64)
    if rotation.shape == (3,):
        forward = rotation
    else:
        forward = _rotation_matrix(rotation) @ np.asarray([0.0, 0.0, -1.0])
    axis = np.cross(forward, direction)
    axis_norm = np.linalg.norm(axis)
    axis = axis / axis_norm if axis_norm > 1e-6 else np.asarray([0.0, 1.0, 0.0])
    theta = math.degrees(math.acos(float(np.clip(np.dot(forward, direction), -1.0, 1.0))))
    return theta if axis[1] > 0 else -theta


def sample_points(points, rooms, min_dist: float = 1.0) -> Tuple[List[int], List[int]]:
    """Greedy ≥min_dist subsampling + room-change indices
    (get_description.py:616-648)."""
    pts = np.asarray(points, np.float64)
    selected = [0]
    last_pt = pts[0]
    room_changes = [0]
    last_room = rooms[0]
    for i in range(1, len(pts)):
        if np.linalg.norm(pts[i] - last_pt) >= min_dist:
            selected.append(i)
            last_pt = pts[i]
        if rooms[i] != last_room:
            room_changes.append(i)
            last_room = rooms[i]
    if len(selected) == 1:
        selected.append(len(pts) - 1)
    return selected, room_changes


def find_sharp_turns(path_points: np.ndarray, threshold: float = 30.0,
                     up_axis: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """Indices + signed angles (degrees, + = left) of turns sharper than
    `threshold` (get_description.py:651-686).

    The reference pre-permutes habitat (x, y-up, z) points to put the up
    axis last and reads the turn sign from the cross product's component
    along it; `up_axis` names that component directly instead (pass 1 for
    raw habitat points, 2 for pre-permuted ones).
    """
    pts = np.asarray(path_points, np.float64)
    v1 = pts[1:-1] - pts[:-2]
    v2 = pts[2:] - pts[1:-1]
    n1 = np.linalg.norm(v1, axis=1, keepdims=True)
    n2 = np.linalg.norm(v2, axis=1, keepdims=True)
    v1 = np.divide(v1, n1, where=n1 != 0)
    v2 = np.divide(v2, n2, where=n2 != 0)
    cos_t = np.clip(np.sum(v1 * v2, axis=1), -1.0, 1.0)
    angles = np.degrees(np.arccos(cos_t))
    signed = angles * np.sign(np.cross(v1, v2)[:, up_axis])
    idx = np.where(np.abs(signed) > threshold)[0] + 1
    return idx, signed[idx - 1]


# --------------------------------------------------------------------------
# Scene-annotation lookups
# --------------------------------------------------------------------------
def _fill_empty_with_nearest(labels: List[str]) -> List[str]:
    """Replace '' entries with the nearest non-empty label (ties → left;
    get_description.py:471-498)."""
    n = len(labels)
    nonempty = [i for i, s in enumerate(labels) if s]
    if not nonempty:
        return labels[:]
    out = labels[:]
    for i in range(n):
        if not out[i]:
            best = min(nonempty, key=lambda j: (abs(j - i), j > i))
            out[i] = labels[best]
    return out


def _minimize_unique_strings(options_per_point: List[List[str]]) -> List[str]:
    """Pick, per point, the globally rarest candidate label (ties →
    alphabetical; get_description.py:501-512)."""
    freq = Counter(s for opts in options_per_point for s in opts)
    return [min(opts, key=lambda s: (freq[s], s)) if opts else ""
            for opts in options_per_point]


class SceneOracle:
    """Room/object lookups over MP3D-style annotations.

    `region_dict`: {scope: [{'label', 'id', 'poly', 'enlarge_poly'}, ...]}
    with polygons in the PLY ground plane (x, -z_habitat).
    `object_dict`: {name: {'scope', 'room', 'position' (habitat xyz),
    'category', 'unique_description', ...}}.
    """

    def __init__(self, object_dict: Dict[str, Dict[str, Any]],
                 region_dict: Dict[str, Any]):
        self.objects = object_dict
        self.regions = region_dict

    # -- rooms ---------------------------------------------------------
    def rooms_at(self, points, poly_key: str = "poly") -> List[List[str]]:
        """Per-point candidate 'scope/room' labels: polygon containment in
        the ply ground plane, then an object-height sanity filter
        (get_points_room, get_description.py:140-166)."""
        pts = np.asarray(points, np.float64)
        ply_xy = np.stack([pts[:, 0], -pts[:, 2]], axis=1)
        candidates: List[List[str]] = [[] for _ in range(len(pts))]
        for scope, rooms in self.regions.items():
            for room in rooms:
                inside = point_in_polygon(ply_xy, np.asarray(room[poly_key]))
                label = f"{scope}/{room['label']}"
                for i in np.where(inside)[0]:
                    candidates[i].append(label)

        heights: Dict[str, List[float]] = defaultdict(list)
        hit = {r for opts in candidates for r in opts}
        for info in self.objects.values():
            key = f"{info['scope']}/{info['room']}"
            if key in hit:
                heights[key].append(info["position"][1])
        span = {k: (min(v), max(v)) for k, v in heights.items()}
        return [
            [r for r in opts
             if r in span and span[r][0] - 1 < pts[i][1] < span[r][1]]
            for i, opts in enumerate(candidates)
        ]

    def rooms_along(self, path, poly_key: str = "poly") -> List[str]:
        rooms = _minimize_unique_strings(self.rooms_at(path, poly_key))
        return _fill_empty_with_nearest(rooms)

    # -- objects -------------------------------------------------------
    def nearest_objects(self, path) -> List[str]:
        """Nearest annotated object (same room) per waypoint
        (get_nearest_object, get_description.py:515-557)."""
        rooms = self.rooms_along(path, "poly")
        if "" in rooms:
            rooms = self.rooms_along(path, "enlarge_poly")
        skip = {"floor", "ceiling", "column", "wall", "light"}
        by_room: Dict[str, Dict[str, np.ndarray]] = defaultdict(dict)
        wanted = set(rooms)
        for name, info in self.objects.items():
            key = f"{info['scope']}/{info['room']}"
            if key in wanted and info["category"] not in skip:
                by_room[key][name] = np.asarray(
                    [info["position"][0], info["position"][2]])
        missing = wanted - set(by_room)
        if missing:
            raise ValueError(f"rooms without objects: {sorted(missing)}")
        out = []
        for i, p in enumerate(np.asarray(path, np.float64)):
            names = list(by_room[rooms[i]].keys())
            dists = np.linalg.norm(
                np.stack(list(by_room[rooms[i]].values())) - p[[0, 2]], axis=1)
            out.append(names[int(dists.argmin())])
        return out

    def landmark_name(self, position, anchor_object: str,
                      choice: Choice = None) -> Optional[str]:
        """Describable landmark near `position` in `anchor_object`'s room:
        the closest non-structural object within 2 m height, phrased with
        one adjective when available (get_object_name,
        get_description.py:240-274)."""
        choice = choice or np.random.choice
        anchor = self.objects[anchor_object]
        pos = np.asarray(position, np.float64)
        in_room = [
            (name, info) for name, info in self.objects.items()
            if info["scope"] == anchor["scope"] and info["room"] == anchor["room"]
        ]
        in_room.sort(key=lambda kv: float(np.linalg.norm(
            np.asarray([kv[1]["position"][0], kv[1]["position"][2]]) - pos[[0, 2]])))
        for _, info in in_room:
            if abs(info["position"][1] - pos[1]) > 2:
                continue
            if info["category"] in ("floor", "ceiling", "wall"):
                continue
            desc = info.get("unique_description")
            if isinstance(desc, dict):
                adjectives = {k: v for k, v in desc.items()
                              if k in ("color", "texture", "material") and v != ""}
                if adjectives:
                    key = choice(list(adjectives.keys()))
                    if key == "texture":
                        return f"{info['category']} with {adjectives[key].lower()} texture"
                    return f"{adjectives[key].lower()} {info['category']}"
            return info["category"]
        return None

    def annotate_path(self, path, height_list=None) -> Dict[int, Dict[str, Any]]:
        """Per-waypoint annotations: nearest object, floor changes, sharp
        turns (on ≥1 m-spaced subsamples), room transitions
        (get_passed_objects_and_regions, get_description.py:560-613)."""
        objs = self.nearest_objects(path)
        info = {i: {"position": path[i], "object": objs[i], "calc_turn": False,
                    "turn": [], "new_room": False} for i in range(len(path))}
        _mark_floor_changes(info, path, height_list)
        sampled, room_changes = sample_points(
            path, [self.objects[o]["room"] for o in objs], 1.0)
        for i in sampled:
            info[i]["calc_turn"] = True
        for i in room_changes:
            info[i]["new_room"] = True
        _mark_sharp_turns(info, sampled)
        return info


def _mark_floor_changes(info, path, height_list) -> None:
    """Append 'up'/'down' where height rises/falls >0.1 m between steps
    (get_description.py:584-596)."""
    heights = [p[1] for p in path] if height_list is None else list(height_list)
    if len(heights) != len(path):
        raise ValueError("height_list and path have different length")
    for i in range(len(heights) - 1):
        if heights[i + 1] - heights[i] > 0.1:
            info[i]["turn"].append("up")
        elif heights[i + 1] - heights[i] < -0.1:
            info[i]["turn"].append("down")


def _mark_sharp_turns(info, sampled: List[int], threshold: float = 40.0,
                      turn_sign: float = 1.0) -> None:
    """Sharp turns on the subsampled polyline, written back to original
    indices (get_description.py:606-612; sign read along the habitat up
    axis, equivalent to the reference's axis permutation). `turn_sign`
    flips the left/right label for mirrored (chirality-reversed) frames —
    see get_description."""
    pts = np.asarray([info[i]["position"] for i in sampled], np.float64)
    turn_idx, turn_angles = find_sharp_turns(pts, threshold=threshold, up_axis=1)
    for k, idx in enumerate(turn_idx):
        info[sampled[int(idx)]]["turn"].append(turn_sign * float(turn_angles[k]))


# --------------------------------------------------------------------------
# Phrase assembly
# --------------------------------------------------------------------------
def _start_phrase(angle_to_first: float, height_diff: float,
                  choice: Choice) -> str:
    """Opening instruction: stairs, or forward with an initial turn
    (get_start_description, get_description.py:212-237)."""
    if height_diff > 0.1:
        return "1. " + choice(PHRASES["go_stairs"]).format(direction="up") + ", "
    if height_diff < -0.1:
        return "1. " + choice(PHRASES["go_stairs"]).format(direction="down") + ", "
    out = "1. " + choice(PHRASES["forward"]) + " along the direction "
    if abs(angle_to_first) >= 120:
        out += "after you " + choice(PHRASES["turn_back"]) + " from your current view, "
    elif angle_to_first > 20:
        out += ("after you " + choice(PHRASES["turn_angle"]).format(
            turn="left", angle=int(round(angle_to_first, -1))) + " from your current view, ")
    elif angle_to_first < -20:
        out += ("after you " + choice(PHRASES["turn_angle"]).format(
            turn="right", angle=int(round(abs(angle_to_first), -1))) + " from your current view, ")
    else:
        out += "from your current view, "
    return out


def _numbered(description: str) -> str:
    return f"{description.count(chr(10)) + 1}. "


def describe_path(rotation, path, object_dict, region_dict,
                  height_list=None, choice: Choice = None,
                  turn_sign: float = 1.0) -> str:
    """Step-by-step route description with scene annotations
    (get_path_description, get_description.py:383-468). `turn_sign=-1`
    flips left/right labels for chirality-reversed point frames."""
    choice = choice or np.random.choice
    if len(path) == 0:
        return ""
    oracle = SceneOracle(object_dict, region_dict)
    info = oracle.annotate_path(path, height_list)
    for i in info:
        info[i]["turn"] = [t if isinstance(t, str) else turn_sign * t
                           for t in info[i]["turn"]]
    special = [i for i in info if (info[i]["new_room"] or info[i]["turn"]) and i != 0]

    angle0 = turn_sign * yaw_rotation_to(
        rotation, info[0]["position"], info[1]["position"])
    h_diff = (info[1]["position"][1] - info[0]["position"][1]
              if height_list is None else height_list[1] - height_list[0])
    out = _start_phrase(angle0, h_diff, choice)

    for i in special:
        room = object_dict[info[i]["object"]]["room"]
        if info[i]["new_room"] and room != "stair region":
            out += (choice(PHRASES["conjunction"]) + " "
                    + choice(PHRASES["go_into_room"]).format(room=room_name(room)) + ", ")
        if info[i]["turn"]:
            landmark = oracle.landmark_name(info[i]["position"],
                                            info[i]["object"], choice)
            for turn in info[i]["turn"]:
                if isinstance(turn, str):
                    continue
                side = "left" if turn > 0 else "right"
                out += (choice(PHRASES["conjunction"]) + " "
                        + choice(PHRASES["turn"]).format(turn=side))
                # rooms with only structural objects yield no landmark —
                # phrase the turn without a preposition instead of "the None"
                if landmark is not None:
                    out += " " + choice(PHRASES["preposition"]).format(object=landmark)
                out += ", "
            stairs = next((d for d in ("up", "down") if d in info[i]["turn"]), None)
            if stairs:
                out += (choice(PHRASES["conjunction"]) + " "
                        + choice(PHRASES["go_stairs"]).format(direction=stairs) + "\n")
                out += _numbered(out)
                continue
        out += "\n"
        out += _numbered(out) + choice(PHRASES["forward"]) + ", "
    return out


def describe_path_plain(rotation, path, height_list=None,
                        choice: Choice = None, turn_sign: float = 1.0) -> str:
    """Route description without scene annotations — turns phrased by
    walked distance instead of landmarks
    (get_path_description_without_additional_info,
    get_description.py:277-380)."""
    choice = choice or np.random.choice
    if len(path) == 0:
        return ""
    info = {i: {"position": path[i], "turn": []} for i in range(len(path))}
    _mark_floor_changes(info, path, height_list)
    sampled, _ = sample_points(path, [""] * len(path), 1.0)
    _mark_sharp_turns(info, sampled, turn_sign=turn_sign)
    special = [i for i in info if info[i]["turn"] and i != 0]

    angle0 = turn_sign * yaw_rotation_to(rotation, info[sampled[0]]["position"],
                                         info[sampled[1]]["position"])
    h_diff = (info[sampled[1]]["position"][1] - info[sampled[0]]["position"][1]
              if height_list is None
              else height_list[sampled[1]] - height_list[sampled[0]])
    out = _start_phrase(angle0, h_diff, choice)

    # NOTE: distances are measured from the path start — the reference
    # never advances its `last_special_point` (get_description.py:331-364);
    # kept for parity.
    origin = np.asarray(info[0]["position"], np.float64)
    for i in special:
        for turn in info[i]["turn"]:
            if isinstance(turn, str):
                continue
            side = "left" if turn > 0 else "right"
            length = round(float(np.linalg.norm(
                np.asarray(info[i]["position"], np.float64) - origin)))
            out += (choice(PHRASES["conjunction"]) + " "
                    + choice(PHRASES["turn"]).format(turn=side) + " "
                    + f"after walking around {length} meters" + ", ")
        stairs = next((d for d in ("up", "down") if d in info[i]["turn"]), None)
        if stairs:
            out += (choice(PHRASES["conjunction"]) + " "
                    + choice(PHRASES["go_stairs"]).format(direction=stairs) + "\n")
            out += _numbered(out)
            continue
        out += "\n"
        out += _numbered(out) + choice(PHRASES["forward"]) + ", "
    return out


# --------------------------------------------------------------------------
# Evaluator entry point
# --------------------------------------------------------------------------
def _dedupe_preserve_order(path: np.ndarray) -> List[np.ndarray]:
    _, idx = np.unique(path, axis=0, return_index=True)
    return list(np.asarray(path)[np.sort(idx)])


def _shortest_path_to_goal(sim, episode) -> Tuple[List, bool]:
    """Shortest navigable path from the agent to the closest reachable goal
    viewpoint (dialog_utils.py:28-43). Uses `sim.find_path` when the
    backend exposes one; otherwise approximates with the episode's
    reference path from the nearest vertex onward."""
    goal_pos = np.asarray(
        episode.extra.get("goal_position", episode.reference_path[-1]), np.float64)
    viewpoints = episode.extra.get("view_points") or [goal_pos]
    viewpoints = sorted(
        (np.asarray(v, np.float64) for v in viewpoints),
        key=lambda v: float(np.linalg.norm(v - goal_pos)))
    start = np.asarray(sim.position, np.float64)
    if hasattr(sim, "find_path"):
        for vp in viewpoints:
            points, ok = sim.find_path(start, vp)
            if ok:
                return list(points), True
        return [], False
    ref = np.asarray(episode.reference_path, np.float64)
    planar_d = np.linalg.norm(ref[:, :2] - start[:2], axis=1)
    nearest = int(planar_d.argmin())
    # navmesh paths never stack two points at one ground location; only
    # prepend the agent when it is meaningfully off the reference polyline
    head = [start] if planar_d[nearest] > 0.25 else []
    return head + list(ref[nearest:]), True


def get_description(sim, episode, object_dict, region_dict,
                    choice: Choice = None) -> Tuple[Optional[str], float]:
    """(path_description, remaining_path_length) for the NPC
    (dialog_utils.py:45-81): truncate the path to its first <4 m, describe
    it from the agent's current heading with a constant height list (floor
    changes are intentionally suppressed mid-episode).

    Sims in this repo speak the planar convention — positions (x, y,
    height), heading = planar atan2 angle (sim_adapter.py FakeSim) — while
    the MP3D annotations are habitat-frame (x, up, z) with region polygons
    in the ply plane (x, -z). Points are permuted planar→habitat here so
    object_dict.json / region_dict.json load unmodified.
    """
    path, ok = _shortest_path_to_goal(sim, episode)
    if not ok:
        # no navigable path: remaining distance is UNKNOWN, not zero —
        # callers judging arrival by `pl` must not read failure as arrival
        return None, float("inf")
    if len(np.unique(np.asarray(path), axis=0)) == 1:
        return None, 0.0  # agent is standing at the goal; nothing to describe
    planar = np.asarray(path, np.float64)
    if planar.shape[1] == 2:
        planar = np.concatenate([planar, np.zeros((len(planar), 1))], axis=1)
    cum = np.concatenate([[0.0], np.cumsum(
        np.linalg.norm(np.diff(planar, axis=0), axis=1))])
    pl = float(cum[-1])
    goal_index = max(i for i, c in enumerate(cum) if c < 4)
    if goal_index == 0:
        # first segment alone is >= 4 m: the reference describes the WHOLE
        # remaining path (dialog_utils.py:59-60), not a single segment
        goal_index = len(planar) - 1
    questioned = _dedupe_preserve_order(planar[: goal_index + 1])
    hab = [np.asarray(p, np.float64)[[0, 2, 1]] for p in questioned]
    heading = float(getattr(sim, "heading", getattr(sim, "yaw", 0.0)))
    forward = np.asarray([math.cos(heading), 0.0, math.sin(heading)])
    pos = np.asarray(sim.position, np.float64)
    height = float(pos[2]) if pos.shape[0] > 2 else 0.0
    heights = [height] * len(hab)
    # the (x, y, h) -> (x, h, y) permutation preserves distances and
    # containment but MIRRORS chirality when the sim's planar frame is
    # right-handed CCW (z-up robotics convention: turn-left = yaw+, like
    # FakeSim). HabitatSimAdapter's planar frame (x, z_hab) is already
    # left-handed (habitat yaw+ about +y is CW in (x, z)), so the
    # permutation lands it exactly in the habitat frame with no flip.
    # Sims declare their convention via `planar_ccw`; CCW is the default.
    turn_sign = -1.0 if bool(getattr(sim, "planar_ccw", True)) else 1.0
    try:
        desc = describe_path(forward, hab, object_dict, region_dict,
                             height_list=heights, choice=choice,
                             turn_sign=turn_sign)
    except Exception:
        desc = describe_path_plain(forward, hab, height_list=heights,
                                   choice=choice, turn_sign=turn_sign)
    return desc, pl
