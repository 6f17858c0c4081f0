"""Image output, procedural meshes and the demo fixture."""
