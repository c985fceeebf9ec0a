"""Physical constants in the framework's internal unit conventions.

The reference derives these from astropy at import time (``models.py:10-12,
1101-1102``, ``bolometric.py:419``, ``filters.py:11``). Here they are computed
once from CODATA-2018 / IAU-2015 base values so the device code uses plain
Python floats (static under jit).

Internal conventions (same as the reference):
  temperature  : kilokelvin (kK)
  radius       : 1000 solar radii (kRsun)
  frequency    : terahertz (THz)
  wavelength   : angstrom (host) / nanometer (filter files)
  L_nu         : watts per hertz (W/Hz)
  luminosity   : watts (W)
  flux         : W / (m^2 Hz)
"""

import math

# CODATA 2018 / IAU 2015 base constants (SI)
H_PLANCK = 6.62607015e-34       # J s (exact)
K_B_SI = 1.380649e-23           # J/K (exact)
C_LIGHT = 2.99792458e8          # m/s (exact)
SIGMA_SB_SI = 2 * math.pi ** 5 * K_B_SI ** 4 / (15 * H_PLANCK ** 3 * C_LIGHT ** 2)  # W m^-2 K^-4
EV = 1.602176634e-19            # J (exact)
R_SUN = 6.957e8                 # m (IAU nominal)
M_SUN = 1.98840987e30           # kg
PC = 3.0856775814913673e16      # m
MPC = PC * 1e6

KILO_RSUN = 1e3 * R_SUN         # m
THZ = 1e12                      # Hz
KK = 1e3                        # K

# k_B in eV per kilokelvin (reference models.py:10)
k_B = K_B_SI / EV * KK

# c3: R_bb = c3 * sqrt(L[erg/s... actually L in W? reference uses L in erg/s units
# implicitly through L_0=2e42 erg/s]) * T_K^-2, with R_bb in kRsun.
# reference models.py:11: c3 = (4 pi sigma_sb[erg s-1 Rsun-2 kK-4])^-0.5 / 1000
SIGMA_SB_ERG_RSUN_KK = SIGMA_SB_SI * 1e7 * R_SUN ** 2 * KK ** 4  # erg s^-1 Rsun^-2 kK^-4
c3 = (4.0 * math.pi * SIGMA_SB_ERG_RSUN_KK) ** -0.5 / 1000.0

# c4: flux = c4 * lum / d_Mpc^2  (reference models.py:12)
c4 = 1.0 / (4.0 * math.pi * MPC ** 2)

# float32 range safety: the hot path may run in float32 (core.config), so
# device-side intermediates must stay within ~[1e-38, 3e38]. Model kernels
# therefore carry luminosity in units of 1e42 erg/s and split tiny constants:
c3_42 = c3 * 1e21          # R_bb = c3_42 * sqrt(L / 1e42 erg/s) * T^-2
c4_30 = c4 * 1e30          # flux = (lum * 1e-30) * c4_30 / d^2

# c1: h nu / k_B T = c1 * nu[THz] / T[kK]  (reference models.py:1101)
c1 = H_PLANCK / K_B_SI * THZ / KK

# c2: L_nu = c2 * R[kRsun]^2 * nu[THz]^3 / (exp(c1 nu/T) - 1) in W/Hz
# (reference models.py:1102: 8 pi^2 h/c^2 per (1000 Rsun)^2 per THz^3)
c2 = 8.0 * math.pi ** 2 * H_PLANCK / C_LIGHT ** 2 * KILO_RSUN ** 2 * THZ ** 3

# speed of light in angstrom * THz (reference filters.py:11)
C_AA_THZ = C_LIGHT * 1e10 / THZ    # = 2.99792458e6: wavelength[AA] = C_AA_THZ / nu[THz]

# Stefan-Boltzmann in W / kRsun^2 / kK^4 (reference bolometric.py:419)
sigma_sb = SIGMA_SB_SI * KILO_RSUN ** 2 * KK ** 4

# absolute-magnitude zero-point offset: M0 = m0 + 90.19 (reference filters.py:156).
# 90.19 = 2.5*log10(4 pi (10 pc in m)^2): converts F_nu zeropoint at 10 pc to L_nu.
M0_OFFSET = 90.19
