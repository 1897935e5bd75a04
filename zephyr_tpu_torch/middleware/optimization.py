'''
A copy of ``zephyr_tpu.middleware.optimization`` (host only: numpy), kept
in the port so that it never imports the JAX package.

Optimization algorithms for the inversion layer.

The reference defers optimization entirely to SimPEG (its
zephyr/middleware/optimization.py is a bare passthrough of
SimPEG.Optimize.Minimize). Here the needed algorithms are implemented
natively: projected gradient (the reference workflow's optimizer,
notebooks/Test Inversion.ipynb cells 4-5), plain gradient descent, and
L-BFGS with bound projection. The model vectors are small (nz * nx), so
the optimizer state lives host-side in numpy; each function/gradient
evaluation is a fused on-device FWI misfit evaluation.
'''

import numpy as np


class StopReason(object):
    MAXITER = 'maxIter reached'
    TOLF = 'tolF reached'
    TOLG = 'tolG reached'
    LINESEARCH = 'line search failed'


class Minimize(object):
    '''
    Base minimizer: backtracking-Armijo line search over a descent
    direction supplied by subclasses.
    '''

    name = 'Minimize'

    def __init__(self, maxIter=20, maxIterLS=20, LSreduction=1e-4,
                 LSshorten=0.5, tolF=1e-3, tolG=1e-4, print_progress=True):
        self.maxIter = maxIter
        self.maxIterLS = maxIterLS
        self.LSreduction = LSreduction
        self.LSshorten = LSshorten
        self.tolF = tolF
        self.tolG = tolG
        self.print_progress = print_progress
        self.callback = None

    # hooks ------------------------------------------------------------------

    def project(self, m):
        return m

    def findSearchDirection(self, m, f, g):
        raise NotImplementedError

    def update(self, m_old, m_new, g_old, g_new):
        'Post-step hook (e.g. L-BFGS memory update).'

    # the minimisation loop ---------------------------------------------------

    def minimize(self, evalFunction, m0):
        '''
        Args:
            evalFunction: m -> (f, g)
            m0: initial model (1D array)

        Returns:
            the final model
        '''

        m = self.project(np.asarray(m0, dtype=np.float64).copy())
        f, g = evalFunction(m)
        f0 = f
        g0norm = np.linalg.norm(g)
        self.f, self.g = f, g
        self.stopReason = StopReason.MAXITER

        for it in range(self.maxIter):
            if self.print_progress:
                print('%s iter %3d: f = %.6e, |g| = %.3e'
                      % (self.name, it, f, np.linalg.norm(g)))

            d = self.findSearchDirection(m, f, g)

            # backtracking line search with projection
            alpha = self.initialStep(m, f, g, d)
            gtd = float(np.dot(g, d))
            success = False
            for _ in range(self.maxIterLS):
                m_new = self.project(m + alpha * d)
                f_new, g_new = evalFunction(m_new)
                if f_new <= f + self.LSreduction * min(0., gtd) * alpha \
                        and f_new < f:
                    success = True
                    break
                alpha *= self.LSshorten
            if not success:
                self.stopReason = StopReason.LINESEARCH
                break

            self.update(m, m_new, g, g_new)
            m, f_old, f, g = m_new, f, f_new, g_new
            self.f, self.g = f, g

            if self.callback is not None:
                self.callback(m, f, g, it)

            if abs(f_old - f) < self.tolF * max(abs(f0), 1e-30):
                self.stopReason = StopReason.TOLF
                break
            if np.linalg.norm(g) < self.tolG * max(g0norm, 1e-300):
                self.stopReason = StopReason.TOLG
                break

        if self.print_progress:
            print('%s done: f = %.6e (%s)' % (self.name, f,
                                              self.stopReason))
        return m

    __call__ = minimize

    def initialStep(self, m, f, g, d):
        '''
        Scale the first step so the model moves a sensible fraction
        (~2% of the model norm) regardless of the raw gradient scale —
        FWI gradients are typically many orders of magnitude smaller
        than the velocity model.
        '''
        dnorm = np.linalg.norm(d)
        if dnorm == 0:
            return 1.0
        mnorm = np.linalg.norm(m)
        if mnorm == 0:
            return 1.0
        return 0.02 * mnorm / dnorm


class GradientDescent(Minimize):

    name = 'GradientDescent'

    def findSearchDirection(self, m, f, g):
        return -g


class ProjectedGradient(Minimize):
    '''
    Gradient descent with bound projection — the optimizer driving the
    reference's end-to-end inversion workflow.
    '''

    name = 'ProjectedGradient'

    def __init__(self, lower=-np.inf, upper=np.inf, **kwargs):
        super().__init__(**kwargs)
        self.lower = lower
        self.upper = upper

    def project(self, m):
        return np.clip(m, self.lower, self.upper)

    def findSearchDirection(self, m, f, g):
        return -g


class LBFGS(Minimize):
    'Limited-memory BFGS with optional bound projection.'

    name = 'LBFGS'

    def __init__(self, memory=10, lower=-np.inf, upper=np.inf, **kwargs):
        super().__init__(**kwargs)
        self.memory = memory
        self.lower = lower
        self.upper = upper
        self._s, self._y = [], []

    def project(self, m):
        return np.clip(m, self.lower, self.upper)

    def update(self, m_old, m_new, g_old, g_new):
        s = m_new - m_old
        y = g_new - g_old
        if float(np.dot(s, y)) > 1e-12 * np.linalg.norm(s) \
                * np.linalg.norm(y):
            self._s.append(s)
            self._y.append(y)
            if len(self._s) > self.memory:
                self._s.pop(0)
                self._y.pop(0)

    def findSearchDirection(self, m, f, g):
        q = g.copy()
        alphas = []
        for s, y in zip(reversed(self._s), reversed(self._y)):
            rho = 1.0 / float(np.dot(y, s))
            a = rho * float(np.dot(s, q))
            alphas.append((a, rho, s, y))
            q -= a * y
        if self._s:
            s, y = self._s[-1], self._y[-1]
            q *= float(np.dot(s, y)) / float(np.dot(y, y))
        for a, rho, s, y in reversed(alphas):
            b = rho * float(np.dot(y, q))
            q += (a - b) * s
        return -q

    def initialStep(self, m, f, g, d):
        if self._s:
            return 1.0
        return super().initialStep(m, f, g, d)
