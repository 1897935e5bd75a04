'''
Composable job profiles for zephyr_tpu_torch: the port of
``zephyr_tpu.frontend.jobs``.

The reference's mixin taxonomy (physics x I/O x task) composed into
runnable jobs such as OmegaJob, over the port's backend and middleware.
A job runs on the card unless its systemConfig's ``device`` key (set
through ``supplementalConfig``, as the CLI's ``--device`` does) says
'cpu'; without a card the default refuses to start.
'''

import pickle

import numpy as np

from .. import backend
from .. import middleware
from ..core.device import DEFAULT_DEVICE, resolve_device


class Job(object):
    '''
    The base class for jobs: assembles a systemConfig from a datastore,
    overlays class-level SystemWrapper / Disc / solver choices and the
    ``supplementalConfig``, and pairs Problem with Survey.
    '''

    Problem = None
    Survey = None
    SystemWrapper = None
    Disc = None
    Solver = None
    projnm = None

    def __init__(self, projnm, supplementalConfig=None):

        self.projnm = projnm

        print('Setting up composite job "%s":' % (self.__class__.__name__,))
        for item in self.__class__.__mro__[:-1][::-1]:
            print('\t%s' % (item.__name__,))
        print()

        systemConfig = self.getSystemConfig(projnm)
        update = {}

        if self.SystemWrapper is not None:
            update['SystemWrapper'] = self.SystemWrapper
        if self.Disc is not None:
            update['Disc'] = self.Disc
        if self.Solver is not None:
            update['Solver'] = self.Solver

        systemConfig.update(update)
        if supplementalConfig is not None:
            systemConfig.update(supplementalConfig)
        if 'projnm' not in systemConfig:
            systemConfig['projnm'] = projnm
        # refuse a missing card here, before any work
        systemConfig['device'] = str(resolve_device(
            systemConfig.get('device', DEFAULT_DEVICE)))

        self.systemConfig = systemConfig
        self.problem = self.Problem(systemConfig)
        self.survey = self.Survey(systemConfig)
        self.problem.pair(self.survey)

    def getSystemConfig(self, projnm):
        raise NotImplementedError

    def run(self):
        raise NotImplementedError

    def saveData(self, data):
        raise NotImplementedError


class ForwardModelingJob(Job):
    'Forward-modelling task: dpred for every source and frequency.'

    def run(self):

        info = {'class': self.__class__.__name__, 'projnm': self.projnm}
        print('Running %(class)s(%(projnm)s)...' % info)

        print('\t- solving system')
        data = self.survey.dpred()
        data.shape = (self.survey.nrec, self.survey.nsrc,
                      self.survey.nfreq)

        print('\t- saving data')
        self.saveData(data)
        print('Done!')
        return data


class InversionJob(Job):
    '''
    Inversion task: reads observed data, runs LBFGS FWI, writes the
    recovered model.
    '''

    maxIter = 10

    def getObservedData(self):
        'Observed data cube (nrec, nsrc, nfreq); override per IO profile.'
        ds = getattr(self, 'ds', None)
        if ds is not None and hasattr(ds, 'spoolData'):
            panels = list(ds.spoolData())
            return np.stack(panels, axis=-1)
        raise NotImplementedError('No observed data source')

    def run(self):

        print('Running %s(%s) inversion...'
              % (self.__class__.__name__, self.projnm))
        dobs = self.getObservedData()
        dmisfit = middleware.l2_DataMisfit(self.survey, dobs)
        opt = middleware.LBFGS(maxIter=self.maxIter)
        invProb = middleware.BaseInvProblem(dmisfit, opt=opt)
        inversion = middleware.BaseInversion(invProb)
        m0 = np.real(np.asarray(self.systemConfig['c'])).ravel()
        m = inversion.run(m0)
        self.saveModel(m)
        print('Done!')
        return m

    def saveModel(self, m):
        from ..middleware.segy import writeSEGY
        model = m.reshape((self.problem.nz, self.problem.nx))
        writeSEGY('%s1.vp' % self.projnm, model.T)
        print('\t- wrote %s1.vp' % self.projnm)


class Visco2DJob(Job):
    '2D viscoacoustic physics profile.'

    Problem = middleware.Helm2DViscoProblem
    Survey = middleware.Helm2DSurvey


class IsotropicVisco2DJob(Visco2DJob):
    'Isotropic (MiniZephyr) variant.'

    Disc = backend.MiniZephyrHD


class AnisotropicVisco2DJob(Visco2DJob):
    'TTI anisotropic (Eurus) variant.'

    Disc = backend.EurusHD


class IniInputJob(Job):
    'Input from projnm.ini + SEG-Y files.'

    def getSystemConfig(self, projnm):
        self.ds = middleware.FullwvDatastore(projnm)
        return self.ds.systemConfig


class PythonInputJob(Job):
    'Input from a projnm.py file.'

    def getSystemConfig(self, projnm):
        self.ds = middleware.FlatDatastore(projnm)
        return self.ds.systemConfig


class PickleInputJob(Job):
    'Input from a projnm.pickle file.'

    def getSystemConfig(self, projnm):
        self.ds = middleware.PickleDatastore(projnm)
        return self.ds.systemConfig


class UtoutOutputJob(Job):
    'Output to projnm.utout.'

    def saveData(self, data):
        utow = middleware.UtoutWriter(self.systemConfig)
        utow(data)


class PickleOutputJob(Job):
    'Output to a pickle file.'

    def saveData(self, data):
        with open(self.projnm, 'wb') as fp:
            pickle.Pickler(fp).dump(data)


class OmegaIOJob(IniInputJob, UtoutOutputJob):
    'Omega-style input/output profile.'


class OmegaJob(IsotropicVisco2DJob, ForwardModelingJob, OmegaIOJob):
    '''
    2D viscoacoustic forward modelling, roughly equivalent to the default
    behaviour of OMEGA.
    '''


class PythonUtoutJob(IsotropicVisco2DJob, ForwardModelingJob,
                     PythonInputJob, UtoutOutputJob):
    'Python config in, utout out.'


class AnisoOmegaJob(AnisotropicVisco2DJob, ForwardModelingJob, OmegaIOJob):
    'TTI anisotropic OmegaJob.'


class AnisoPythonUtoutJob(AnisotropicVisco2DJob, ForwardModelingJob,
                          PythonInputJob, UtoutOutputJob):
    'TTI anisotropic PythonUtoutJob.'


class MigrationJob(InversionJob):
    '''
    Migration task: a single adjoint-state gradient (reverse-time image)
    at the starting model, written in the FULLWV gradient-file convention
    (projnm1.gvp).
    '''

    def run(self):

        print('Running %s(%s) migration...'
              % (self.__class__.__name__, self.projnm))
        dobs = self.getObservedData()
        m0 = np.real(np.asarray(self.systemConfig['c'])).ravel()
        _, g = self.problem.misfit_and_gradient(
            m0.reshape(self.problem.nz, self.problem.nx), dobs)
        self.saveImage(g)
        print('Done!')
        return g

    def saveImage(self, g):
        from ..middleware.segy import writeSEGY
        image = g.reshape((self.problem.nz, self.problem.nx))
        writeSEGY('%s1.gvp' % self.projnm, image.T)
        print('\t- wrote %s1.gvp' % self.projnm)


class OmegaInversionJob(IsotropicVisco2DJob, InversionJob, OmegaIOJob):
    'FWI against an OMEGA project directory.'


class OmegaMigrationJob(IsotropicVisco2DJob, MigrationJob, OmegaIOJob):
    'Adjoint-state migration against an OMEGA project directory.'
