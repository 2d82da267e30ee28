"""The benchmark's plain reference: the problem's operator and the map of
the program's dofs onto the reference's own mesh (fem.py), one module per
mesh that a configuration's ``reference`` key names (hyper_cube_q1.py,
hyper_ball_q1.py), a plain conjugate-gradient solver for the control
(solver.py) and the comparison that decides ``correct`` (judge.py).  Plain
PyTorch, NumPy and SciPy; nothing here imports the program, JAX or the JAX
package."""
