"""Plain references of the benchmark's configurations, in PyTorch with no
code of the program: each works its answer out again from the generated
scene.  ``precision`` gives the arithmetic a reference runs in: float64,
and the controls' float32 and TF32."""
