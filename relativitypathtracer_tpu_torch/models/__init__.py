"""Host scene model: DSL parser, OBJ/texture loaders, octree, scene tensors."""
