"""Host-side models: materials, transforms, triangle SoA, camera."""
