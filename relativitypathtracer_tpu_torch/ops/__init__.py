"""Per-ray math: boosts, intersections, camera, tonemap, mesh constants."""
