"""Synthetic CATER scene simulator (no Blender), the port's copy of
`objectpermanence_tpu/datagen/simulator.py`. Host numpy: the same seed draws
the same `np.random` numbers in the same order, so the scenes, their jsons
and the `<name>_bb.json` boxes are JAX's byte for byte.

Generates scene jsons + GT `<name>_bb.json` files in the real CATER schema
(`generate/render_videos.py:359-461`'s outputs), using the actual CATER
camera matrix for 2D boxes, so the whole label pipeline (datagen/
scene_labels, datagen/perfect_perception, ingest, training) runs without
any rendered pixels.

Scene dynamics are a port of the reference's RANDOMIZED action planner
(`generate/actions.py`), not a scripted timeline:
- time is consumed interval by interval; each interval randomly runs either
  a multi-object containment attempt (`add_movements_multiObj_try`,
  `actions.py:78-149`) or a single-object action round
  (`add_movements_singleObj`, `:190-260`)
- only a cone that currently contains nothing may contain, and only a
  strictly smaller cone/sphere/spl (`_can_contain`, `:152-177`); contained
  groups are merged TOP-MOST FIRST and move together, enabling nested
  ("babushka") containment when a loaded cone is itself contained
- per-group actions: `_slide` / `_pick_place` / `_rotate` / `_no_op` with
  the reference's shape restrictions (`add_movements`, `:309-335`); a
  loaded group either slides together or the top cone `_pick_place`s away,
  splitting the group (release)
- every candidate motion is rejection-sampled against sphere-model
  collisions with all other groups over all remaining frames
  (`_no_object_overlaps` / `_obj_overlap`, `:396-419`), falling back to
  `_no_op` after MAX_TRIALS; a global validator tolerating contained
  overlap mirrors `assert_no_collisions` (`:265-306`)
- `_pick_place` follows the reference's 20% lift / 60% carry / 20% drop
  trajectory at PICK_HEIGHT (`:480-508`)
"""

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from objectpermanence_tpu_torch import FRAME_HEIGHT, FRAME_WIDTH, VIDEO_NUM_FRAMES
from objectpermanence_tpu_torch.ops.homography import project_3d_point
from objectpermanence_tpu_torch.vocab import COLORS, MATERIALS

# CATER object footprints (half-extent == the reference's 'sized', height)
SIZE_GEOMETRY = {"small": (0.35, 0.7), "medium": (0.5, 1.0), "large": (0.7, 1.4)}
PLAY_RADIUS = 2.8   # objects live on the [-3, 3]^2 plane
PICK_HEIGHT = 2.0   # actions.py:10
MAX_TRIALS = 100    # actions.py:11
MIN_DIST = 0.25     # render_videos.py --min_dist default
# reference interval lengths at 300 frames (actions.py:12-13); scaled by T/300
MOVEMENT_MIN, MOVEMENT_MAX, START_JITTER = 20, 30, 10


@dataclass
class SimObject:
    instance: str
    shape: str
    size: str
    color: str
    material: str
    positions: np.ndarray = None           # (T, 3) base-center positions
    actions: List[list] = field(default_factory=list)
    contained_by: Optional[str] = None

    @property
    def class_name(self) -> str:
        return f"{self.size}_{self.color}_{self.shape}_{self.material}"

    @property
    def track_name(self) -> str:
        return f"{self.class_name}_{self.instance}"

    @property
    def sized(self) -> float:
        return SIZE_GEOMETRY[self.size][0]


def _project_box(center: np.ndarray, half: float, height: float,
                 cam: np.ndarray = None) -> List[float]:
    """Project the 8 corners of an object's bounding volume to a 2D xywh
    pixel box (mirrors `camera_view_bounds_2d`, `render_videos.py:623-687`).
    `cam` overrides the fixed camera (camera-motion mode)."""
    cx, cy, cz = center
    corners = np.array([
        [cx + sx * half, cy + sy * half, cz + sz * height]
        for sx in (-1, 1) for sy in (-1, 1) for sz in (0, 1)
    ])
    img = project_3d_point(corners, cam=cam)  # [-1, 1], y negated already
    xs = (img[:, 0] + 1) * FRAME_WIDTH / 2
    ys = (img[:, 1] + 1) * FRAME_HEIGHT / 2
    x1 = float(np.clip(xs.min(), 0, FRAME_WIDTH - 1))
    y1 = float(np.clip(ys.min(), 0, FRAME_HEIGHT - 1))
    x2 = float(np.clip(xs.max(), 1, FRAME_WIDTH))
    y2 = float(np.clip(ys.max(), 1, FRAME_HEIGHT))
    return [x1, y1, x2 - x1, y2 - y1]


def _interp(a: np.ndarray, b: np.ndarray, steps: int) -> np.ndarray:
    """(steps, 3) linear path from a to b inclusive (reference
    `move_to_location`, np.interp endpoints)."""
    alphas = np.linspace(0.0, 1.0, steps)[:, None]
    return a[None] + alphas * (b[None] - a[None])


def _slide_traj(init: np.ndarray, x: float, y: float, steps: int) -> np.ndarray:
    return _interp(init, np.array([x, y, init[2]]), steps)


def _pick_place_traj(init: np.ndarray, x: float, y: float, steps: int
                     ) -> np.ndarray:
    """20% lift to PICK_HEIGHT, 60% carry, 20% drop (actions.py:480-508)."""
    up = init + np.array([0.0, 0.0, PICK_HEIGHT])
    n1 = max(int(0.2 * steps), 1)
    n3 = max(int(0.2 * steps), 1)
    n2 = max(steps - n1 - n3, 1)
    carry_end = np.array([x, y, up[2]])
    drop_end = np.array([x, y, init[2]])
    path = np.concatenate([
        _interp(init, up, n1),
        _interp(up, carry_end, n2),
        _interp(carry_end, drop_end, n3),
    ])
    if len(path) >= steps:
        return path[:steps]
    return np.concatenate([path, np.repeat(path[-1:], steps - len(path), 0)])


class SceneSimulator:
    """Randomized (but seed-deterministic) planner-driven scene builder."""

    def __init__(self, seed: int, num_frames: int = VIDEO_NUM_FRAMES,
                 num_objects: int = 6, snitch_bias: float = 0.0,
                 camera_motion: bool = False):
        self.rng = np.random.RandomState(seed)
        self.num_frames = num_frames
        self.num_objects = num_objects
        # probability that a containment attempt targets the snitch's group
        # first (0.0 == the reference's uniform pair sampling; >0 balances
        # training data toward snitch containment)
        self.snitch_bias = snitch_bias
        # optional random camera motion (reference
        # `render_videos.py:809-843`): camera location re-keyframed every 30
        # frames, rotation/intrinsics fixed. Off by default (the reference's
        # default too). Uses a DEDICATED rng stream so fixed-camera scenes
        # stay byte-identical for any seed whether or not the flag exists.
        self.camera_motion = camera_motion
        self._camera_keyframes = (
            self._random_camera_keyframes(np.random.RandomState(seed + 7919))
            if camera_motion else None)
        scale = num_frames / 300.0
        self.mmin = max(4, int(round(MOVEMENT_MIN * scale)))
        self.mmax = max(self.mmin + 2, int(round(MOVEMENT_MAX * scale)))
        self.jitter = max(2, int(round(START_JITTER * scale)))

    def _random_camera_keyframes(self, rng) -> List[Tuple[int, np.ndarray]]:
        """Keyframe schedule mirroring the reference's
        `add_random_camera_motion` (`render_videos.py:823-843`): start at
        the base camera; every 30 frames move EITHER x or y to +-10 (never
        both — (0,0,z) is a singularity) and z to one of {8,10,12}.
        Blender's keyframe_insert records the camera's full current
        location, so unset coordinates persist from the previous keyframe."""
        from objectpermanence_tpu_torch.ops.homography import camera_center

        cur = camera_center().copy()
        keys = [(0, cur.copy())]
        shift_interval = 30
        for frame_id in range(shift_interval, self.num_frames,
                              shift_interval):
            if rng.random_sample() > 0.5:
                cur[0] = rng.choice([-10, 10])
            else:
                cur[1] = rng.choice([-10, 10])
            cur[2] = rng.choice([8, 10, 12])
            keys.append((frame_id, cur.copy()))
        keys.append((self.num_frames, cur.copy()))
        return keys

    def camera_location(self, frame: int) -> Optional[np.ndarray]:
        """Per-frame camera location (linear interpolation between
        keyframes — an approximation of Blender's default Bezier f-curves),
        or None in fixed-camera mode."""
        if self._camera_keyframes is None:
            return None
        keys = self._camera_keyframes
        for (f0, p0), (f1, p1) in zip(keys, keys[1:]):
            if f0 <= frame <= f1:
                a = 0.0 if f1 == f0 else (frame - f0) / (f1 - f0)
                return p0 + a * (p1 - p0)
        return keys[-1][1]

    # ------------------------------------------------------------------
    # world setup
    # ------------------------------------------------------------------

    def _random_xy(self) -> Tuple[float, float]:
        return (self.rng.uniform(-PLAY_RADIUS, PLAY_RADIUS),
                self.rng.uniform(-PLAY_RADIUS, PLAY_RADIUS))

    def _make_objects(self) -> List[SimObject]:
        """First three objects are always snitch / medium cone / large cone
        (`render_videos.py:846-979`); spawns are min-dist rejection
        sampled."""
        objs = [
            SimObject("Spl_0", "spl", "small", "gold", "metal"),
            SimObject("Cone_1", "cone", "medium",
                      self.rng.choice(COLORS), self.rng.choice(MATERIALS)),
            SimObject("Cone_2", "cone", "large",
                      self.rng.choice(COLORS), self.rng.choice(MATERIALS)),
        ]
        shapes = ["cube", "cylinder", "sphere", "cone"]
        for k in range(3, self.num_objects):
            shape = str(self.rng.choice(shapes))
            # instance names carry the shape like Blender object names do —
            # the label tooling identifies containers by "Cone" in the name
            # (`gen_video_labels.py` and our scene_labels/perfect_perception)
            objs.append(SimObject(
                f"{shape.capitalize()}_{k}", shape,
                self.rng.choice(["small", "medium", "large"]),
                self.rng.choice(COLORS), self.rng.choice(MATERIALS)))

        placed = []
        for obj in objs:
            for _ in range(100):
                x, y = self._random_xy()
                ok = all(
                    np.hypot(x - px, y - py) - obj.sized - po.sized >= MIN_DIST
                    for (px, py), po in placed)
                if ok:
                    break
            placed.append(((x, y), obj))
            obj.positions = np.tile(np.array([x, y, 0.0]),
                                    (self.num_frames, 1))
        return objs

    # ------------------------------------------------------------------
    # collision model (actions.py:396-419)
    # ------------------------------------------------------------------

    def _traj_clear(self, traj: np.ndarray, size: float, start: int,
                    objs, groups, skip: set) -> bool:
        """True iff `traj` (then holding its final point) stays min-dist
        clear of EVERY MEMBER of every other group from `start` to the end
        of the scene (`_no_object_overlaps`; the reference deliberately
        compares against all members, not just tops — a released inner
        object keeps sitting where its group was, actions.py:225-229)."""
        T = self.num_frames
        span = T - start
        mine = np.empty((span, 3))
        n = min(len(traj), span)
        mine[:n] = traj[:n]
        mine[n:] = traj[-1]
        for gi, group in enumerate(groups):
            if gi in skip:
                continue
            for idx in group:
                other = objs[idx]
                d = np.linalg.norm(mine - other.positions[start:T], axis=1)
                if np.any(d - size - other.sized < MIN_DIST):
                    return False
        return True

    # ------------------------------------------------------------------
    # containment record (movement_record.py semantics)
    # ------------------------------------------------------------------

    def _record_contain(self, top: SimObject, inner: SimObject, start: int):
        # generous timing: contained from the contain op's START until the
        # cone's next pick_place (movement_record.py:42-53)
        self.contains[top.instance][start:] = inner.instance
        inner.contained_by = top.instance

    def _record_release(self, top: SimObject, end: int):
        held = self.contains[top.instance][min(end, self.num_frames - 1)]
        self.contains[top.instance][end:] = None
        if held is not None:
            for o in self._objs:
                if o.instance == held:
                    o.contained_by = None

    def was_contained(self, a: Optional[str], b: str, frame: int) -> bool:
        """True iff b is (transitively) contained in a at `frame`
        (movement_record.py:79-85)."""
        if a is None:
            return False
        if a == b:
            return True
        return self.was_contained(self.contains[a][frame], b, frame)

    def validate_no_collisions(self, objs, groups) -> None:
        """`assert_no_collisions` (actions.py:265-306): pairwise top-object
        clearance over all frames, tolerating contained overlap."""
        tops = [objs[g[0]] for g in groups]
        for i, a in enumerate(tops):
            for b in tops[i + 1:]:
                d = np.linalg.norm(a.positions - b.positions, axis=1)
                bad = np.nonzero(d - a.sized - b.sized < MIN_DIST)[0]
                for f in bad:
                    if (self.was_contained(a.instance, b.instance, int(f)) or
                            self.was_contained(b.instance, a.instance, int(f))):
                        continue
                    raise AssertionError(
                        f"overlap between {a.instance} and {b.instance} "
                        f"at frame {int(f)}")

    # ------------------------------------------------------------------
    # actions
    # ------------------------------------------------------------------

    def _commit(self, obj: SimObject, traj: np.ndarray, start: int, end: int):
        obj.positions[start:end + 1] = traj
        obj.positions[end + 1:] = traj[-1]

    def _add_group_movement(self, objs, groups, gi: int, start: int, end: int
                            ) -> bool:
        """One action for group `gi` over [start, end]; returns True if the
        group split (release). Mirrors `add_movements` (actions.py:309-393)."""
        group = groups[gi]
        members = [objs[i] for i in group]
        top = members[0]
        steps = end - start + 1

        if len(group) > 1:
            options = ["group_slide", "release"]
        elif top.shape in ("cone", "sphere"):
            options = ["slide", "pick_place"]
        else:
            options = ["slide", "pick_place", "rotate"]

        for _ in range(MAX_TRIALS):
            action = options[self.rng.randint(len(options))]
            if action == "rotate":
                self.movements[top.instance].append(
                    ["_rotate", None, start, end])
                return False
            x, y = self._random_xy()

            if action == "group_slide":
                trajs = [_slide_traj(m.positions[start], x, y, steps)
                         for m in members]
                if not all(self._traj_clear(t, m.sized, start, objs, groups,
                                            {gi})
                           for t, m in zip(trajs, members)):
                    continue
                for m, t in zip(members, trajs):
                    self._commit(m, t, start, end)
                    self.movements[m.instance].append(
                        ["_slide", None, start, end])
                return False

            if action == "release":
                traj = _pick_place_traj(top.positions[start], x, y, steps)
                if not self._traj_clear(traj, top.sized, start, objs, groups,
                                        {gi}):
                    continue
                # split requires the endpoints to be apart (actions.py:365-369)
                inner = members[1]
                if (np.linalg.norm(traj[-1] - inner.positions[end])
                        - top.sized - inner.sized < MIN_DIST):
                    continue
                self._commit(top, traj, start, end)
                self.movements[top.instance].append(
                    ["_pick_place", None, start, end])
                for m in members[1:]:
                    self.movements[m.instance].append(
                        ["_no_op", None, start, end])
                self._record_release(top, end)
                return True

            # single-object slide / pick_place
            make = _slide_traj if action == "slide" else _pick_place_traj
            traj = make(top.positions[start], x, y, steps)
            if not self._traj_clear(traj, top.sized, start, objs, groups, {gi}):
                continue
            self._commit(top, traj, start, end)
            name = "_slide" if action == "slide" else "_pick_place"
            self.movements[top.instance].append([name, None, start, end])
            if name == "_pick_place":
                self._record_release(top, end)  # no-op unless it held one
            return False

        # MAX_TRIALS exhausted -> no_op (actions.py:367-374)
        for m in members:
            self.movements[m.instance].append(["_no_op", None, start, end])
        return False

    def _single_obj_round(self, objs, groups, cur: int, ignore=()) -> int:
        """One per-interval round of single-group actions
        (`add_movements_singleObj`)."""
        T = self.num_frames
        order = [int(g) for g in self.rng.permutation(len(groups))
                 if g not in ignore]
        last_end = cur
        split_gis = []
        for gi in order:
            dur = self.rng.randint(self.mmin, self.mmax + 1)
            s = cur + self.rng.randint(0, self.jitter + 1)
            e = min(s + dur, T - 1)
            if e <= s:
                continue
            if self._add_group_movement(objs, groups, gi, s, e):
                split_gis.append(gi)
            last_end = max(last_end, e)
        # split released groups after the round (actions.py:246-259)
        new_groups = []
        for gi, group in enumerate(groups):
            if gi in split_gis:
                new_groups.append([group[0]])
                new_groups.append(group[1:])
            else:
                new_groups.append(group)
        groups[:] = new_groups
        self.validate_no_collisions(objs, groups)
        return last_end

    def _multi_obj_try(self, objs, groups, cur: int) -> int:
        """Containment attempt + single-object round for the rest
        (`add_movements_multiObj_try`). Returns the interval's end frame,
        or cur - 1 if no containable pair was found."""
        T = self.num_frames
        for _ in range(MAX_TRIALS):
            if len(groups) < 2:
                break
            if self.snitch_bias and self.rng.rand() < self.snitch_bias:
                # bias: target the group whose top carries the snitch signal
                i2 = next(gi for gi, g in enumerate(groups)
                          if any(objs[i].instance == "Spl_0" for i in g))
                others = [gi for gi in range(len(groups)) if gi != i2]
                i1 = others[self.rng.randint(len(others))]
            else:
                i1, i2 = self.rng.choice(len(groups), 2, replace=False)
            dur = self.rng.randint(self.mmin, self.mmax + 1)
            s = cur + self.rng.randint(0, self.jitter + 1)
            e = min(s + dur, T - 1)
            if e <= s:
                continue
            g1, g2 = groups[int(i1)], groups[int(i2)]
            top1, top2 = objs[g1[0]], objs[g2[0]]
            # _can_contain (actions.py:152-177): an unloaded cone over a
            # strictly smaller cone/sphere/spl
            if not (len(g1) == 1 and top1.shape == "cone"
                    and top1.sized > top2.sized
                    and top2.shape in ("cone", "sphere", "spl")):
                continue
            target = top2.positions[s]
            traj = _pick_place_traj(top1.positions[s], target[0], target[1],
                                    e - s + 1)
            # collision check vs everyone but the pair (the cone must land ON
            # the target, which is an 'overlap' the record will sanction)
            if not self._traj_clear(traj, top1.sized, s, objs, groups,
                                    {int(i1), int(i2)}):
                continue

            self._commit(top1, traj, s, e)
            self.movements[top1.instance].append(
                ["_contain", top2.instance, s, e])
            self._record_contain(top1, top2, s)

            # merge groups, TOP-MOST FIRST (actions.py:121-126)
            merged = g1 + g2
            groups[int(i1)] = merged
            groups.pop(int(i2))
            affected = int(i1) if i1 < i2 else int(i1) - 1
            self.validate_no_collisions(objs, groups)

            round_end = self._single_obj_round(objs, groups, cur,
                                               ignore=[affected])
            return max(e, round_end)
        return cur - 1

    # ------------------------------------------------------------------
    # top level
    # ------------------------------------------------------------------

    def build(self) -> Tuple[List[SimObject], Dict[str, List[list]]]:
        T = self.num_frames
        objs = self._make_objects()
        self._objs = objs
        self.movements = {o.instance: [] for o in objs}
        self.contains = {o.instance: np.full(T, None, dtype=object)
                         for o in objs}
        groups = [[i] for i in range(len(objs))]

        cur = 0
        # interval loop (random_objects_movements, actions.py:31-68)
        while cur <= T - 1 - self.mmax:
            if self.rng.rand() < 0.5:
                end = self._multi_obj_try(objs, groups, cur)
            else:
                end = self._single_obj_round(objs, groups, cur)
            cur = max(end, cur) + 1

        self.validate_no_collisions(objs, groups)
        for obj in objs:
            if not self.movements[obj.instance]:
                self.movements[obj.instance].append(["_no_op", None, 0,
                                                     min(10, T - 1)])
        return objs, self.movements

    def scene_json(self, objs, movements) -> dict:
        return {
            "objects": [
                {
                    "instance": o.instance, "shape": o.shape, "size": o.size,
                    "color": str(o.color), "material": str(o.material),
                    "locations": {str(f): [float(v) for v in o.positions[f]]
                                  for f in range(self.num_frames)},
                }
                for o in objs
            ],
            "movements": {k: [[a, other, int(s), int(e)]
                              for a, other, s, e in v]
                          for k, v in movements.items()},
            # additive: fixed-camera scenes omit the key entirely, so all
            # existing scene jsons and their consumers are unchanged
            **({"camera_motion": {
                "keyframes": [[int(f), [float(v) for v in p]]
                              for f, p in self._camera_keyframes]}}
               if self.camera_motion else {}),
        }

    def gt_bb_json(self, objs) -> dict:
        from objectpermanence_tpu_torch.ops.homography import camera_matrix_at

        cams = None
        if self.camera_motion:
            cams = [camera_matrix_at(self.camera_location(f))
                    for f in range(self.num_frames)]
        tracks = {}
        for o in objs:
            half, height = SIZE_GEOMETRY[o.size]
            tracks[o.track_name] = [
                _project_box(o.positions[f], half, height,
                             cam=None if cams is None else cams[f])
                for f in range(self.num_frames)
            ]
        return tracks


def scene_has_snitch_containment(movements: Dict[str, List[list]]) -> bool:
    return any(m[0] == "_contain" and m[1] == "Spl_0"
               for moves in movements.values() for m in moves)


def simulate_dataset(root, num_videos: int = 8, seed: int = 0,
                     num_frames: int = VIDEO_NUM_FRAMES,
                     num_objects: int = 6, snitch_bias: float = 0.5,
                     require_snitch_containment: bool = True,
                     camera_motion: bool = False
                     ) -> Tuple[Path, Path]:
    """Write scenes/ + labels/ for `num_videos` simulated scenes.
    With `require_snitch_containment` (training-data default), scenes whose
    random plan never contains the snitch are re-rolled deterministically.
    Returns (scenes_dir, labels_dir)."""
    root = Path(root)
    scenes_dir = root / "scenes"
    labels_dir = root / "labels"
    scenes_dir.mkdir(parents=True, exist_ok=True)
    labels_dir.mkdir(parents=True, exist_ok=True)

    # the disjoint-block guarantee below only holds while every video's
    # attempt range stays inside this split seed's 2^20 block
    if num_videos * 64 >= 2 ** 20:
        raise ValueError(
            f"num_videos={num_videos} overflows the split seed block "
            f"(num_videos * 64 must stay < 2^20); use multiple splits")

    for v in range(num_videos):
        name = f"CATER_sim_{v:06d}"
        for attempt in range(64):
            # disjoint seed blocks: the split seed owns a 2^20 range, each
            # video a 64-wide sub-range for its re-roll attempts — different
            # split seeds can never collide (a v*1000-style scheme made dev
            # scenes byte-identical to train scenes)
            sim = SceneSimulator((seed << 20) + v * 64 + attempt,
                                 num_frames, num_objects,
                                 snitch_bias=snitch_bias,
                                 camera_motion=camera_motion)
            objs, movements = sim.build()
            if (not require_snitch_containment
                    or scene_has_snitch_containment(movements)):
                break
        with open(scenes_dir / f"{name}.json", "w") as f:
            json.dump(sim.scene_json(objs, movements), f)
        with open(labels_dir / f"{name}_bb.json", "w") as f:
            json.dump(sim.gt_bb_json(objs), f)
    return scenes_dir, labels_dir
