'''
A copy of ``zephyr_tpu.middleware.inversion`` (host only: numpy and
``.optimization``), kept in the port so that it never imports the JAX
package; the problems it drives run on the card unless their
systemConfig's ``device`` key says 'cpu'.

Inversion drivers: data misfit, inverse problem, and inversion loop.

The reference wires these concepts through SimPEG
(DataMisfit.l2_DataMisfit, InvProblem.BaseInvProblem,
Inversion.BaseInversion; see SURVEY.md section 3.5). They are implemented
natively here on top of the exact fused misfit/gradient of
``HelmBaseProblem.misfit_and_gradient`` — each optimizer iteration is one
on-device value-and-grad evaluation over all frequencies and sources.

``FrequencyContinuation`` implements the multiscale FWI workflow that the
reference realizes by config (MultiGrid problems + frequency blocks;
SURVEY.md section 3.5): invert low-frequency blocks first, feeding each
result into the next block.
'''

import numpy as np

from .optimization import ProjectedGradient


class l2_DataMisfit(object):
    '''
    0.5 || dpred(m) - dobs ||^2 over complex data, with the exact model
    gradient (SimPEG l2_DataMisfit surface).
    '''

    def __init__(self, survey, dobs=None):
        self.survey = survey
        self.prob = survey.prob
        self.dobs = np.asarray(dobs).ravel() if dobs is not None else \
            np.asarray(survey.dobs).ravel()

    def eval(self, m=None):
        r = self.survey.dpred(m) - self.dobs
        return 0.5 * float(np.real(np.vdot(r, r)))

    def evalDeriv(self, m=None):
        return self.prob.misfit_and_gradient(m, self.dobs)[1]

    def eval_and_deriv(self, m=None):
        return self.prob.misfit_and_gradient(m, self.dobs)

    __call__ = eval


class BaseInvProblem(object):
    '''
    phi(m) = phi_d(m) + beta * phi_m(m): data misfit plus weighted
    regularization (SimPEG InvProblem surface).
    '''

    def __init__(self, dmisfit, reg=None, opt=None, beta=0.0):
        self.dmisfit = dmisfit
        self.reg = reg
        self.beta = beta
        self.opt = opt if opt is not None else ProjectedGradient()

    def evalFunction(self, m):
        f, g = self.dmisfit.eval_and_deriv(m)
        if self.reg is not None and self.beta > 0:
            f = f + self.beta * self.reg.eval(m)
            g = g + self.beta * self.reg.evalDeriv(m)
        return f, g


class BaseInversion(object):
    'Runs the optimization over the inverse problem (SimPEG surface).'

    def __init__(self, invProb, directiveList=()):
        self.invProb = invProb
        self.directiveList = list(directiveList)

    def run(self, m0):
        for directive in self.directiveList:
            if hasattr(directive, 'initialize'):
                directive.initialize(self)
        m = self.invProb.opt.minimize(self.invProb.evalFunction,
                                      np.asarray(m0, dtype=np.float64)
                                      .ravel())
        for directive in self.directiveList:
            if hasattr(directive, 'finish'):
                directive.finish(self)
        return m


class FrequencyContinuation(object):
    '''
    Multiscale FWI driver: sweep frequency blocks from low to high,
    warm-starting each block with the previous result. The block
    structure mirrors OMEGA's frequency groups (the reference drives this
    via ini frequency blocks and MultiGrid configs; SURVEY.md section 5).
    '''

    def __init__(self, problemClass, surveyClass, systemConfig, dobs,
                 blocks, optFactory=None):
        '''
        Args:
            problemClass, surveyClass: middleware classes to pair
            systemConfig: full config (with the complete freqs list)
            dobs: observed data cube (nrec, nsrc, nfreq) for all freqs
            blocks: list of index arrays into the full frequency list
            optFactory: () -> Minimize instance per block
        '''

        self.problemClass = problemClass
        self.surveyClass = surveyClass
        self.systemConfig = dict(systemConfig)
        self.dobs = np.asarray(dobs)
        self.blocks = blocks
        self.optFactory = optFactory or (lambda: ProjectedGradient())
        self.history = []

    def run(self, m0):
        m = np.asarray(m0, dtype=np.float64).ravel()
        freqs = list(self.systemConfig['freqs'])

        for iblock, block in enumerate(self.blocks):
            sc = dict(self.systemConfig)
            sc['freqs'] = [freqs[i] for i in block]
            sc['c'] = m.copy()
            sterms = sc.get('sterms', None)
            if sterms is not None:
                sterms = np.asarray(sterms)
                if sterms.ndim == 1 and sterms.size == len(freqs):
                    sc['sterms'] = sterms[list(block)]
                elif sterms.ndim == 2 and sterms.shape[0] == len(freqs):
                    sc['sterms'] = sterms[list(block)]

            problem = self.problemClass(sc)
            survey = self.surveyClass(sc)
            problem.pair(survey)

            dobs_block = self.dobs[:, :, list(block)]
            dmisfit = l2_DataMisfit(survey, dobs_block)
            invProb = BaseInvProblem(dmisfit, opt=self.optFactory())
            inversion = BaseInversion(invProb)
            m = inversion.run(m)
            self.history.append(
                {'block': list(block), 'f': invProb.opt.f})

        return m
