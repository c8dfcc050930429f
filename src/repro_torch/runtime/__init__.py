"""The serving runtime (`serve`), its fault-tolerance primitives (`fault`)
and its deterministic fault injectors (`inject`)."""
