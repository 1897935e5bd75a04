'''
The plain reference that decides ``correct``: numpy and torch only, and
nothing of the program under test. It builds the operator, the stamps
and the grids from the same medium and geometry the program is given,
and solves directly (``blocksolve``).
'''
