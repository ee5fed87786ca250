"""Dataset and label generation (offline, host numpy), the port's copy of
`objectpermanence_tpu/datagen/`: the scene simulator, the label tooling
(`scene_labels.py`, `cater_tasks.py`), perfect perception and the renderer.
Blender rendering itself stays external tooling. Consumes the CATER
scene-json schema:

- `scene["objects"]`: [{instance, size, color, shape, material,
  locations: {frame: [x, y, z]}}]
- `scene["movements"]`: {instance: [(action_name, target_or_None,
  start_frame, end_frame), ...]} where `_contain` actions carry the
  contained instance as target and containment runs from the contain
  action's END frame until the cone's next `_pick_place` START frame.
"""
