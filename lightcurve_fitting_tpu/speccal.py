#!/usr/bin/env python
"""Spectral calibration: read spectra (FITS/ASCII/OSC-JSON), identify their
observation dates/instruments heuristically, and calibrate them to broadband
photometry. Host-only I/O module; API parity with the reference
``lightcurve_fitting/speccal.py`` using the framework's own FITS/Time utilities
(astropy is not a dependency).
"""

import argparse
import json
import os
import re
import shutil

import numpy as np

from .lightcurve import LC
from .utils import fits as ufits
from .utils.timeutil import Time
from .utils.table import Table
from .core.constants import C_AA_THZ

__all__ = ["readfitsspec", "convert_spectrum_units", "readOSCspec", "readspec",
           "calibrate_spectra", "create_wiserep_tsv"]

C_M_S = 2.99792458e8


def removebadcards(hdr):
    """Compatibility shim (reference speccal.py:19-32): our FITS reader is
    lenient by construction, so malformed cards are already skipped."""
    return hdr


def remove_duplicate_wcs(hdr, keep_number=0):
    """Compatibility shim (reference speccal.py:35-43): our header is a dict,
    so duplicate keywords collapse to the last occurrence on read."""
    return hdr


def readfitsspec(filename, header=False, ext=None):
    """Read a 1-D spectrum from a FITS file (reference speccal.py:46-102):
    prefer a SCI extension, else the first HDU with data; binary tables use
    their 'wavelength'/'flux' columns; images use the linear wavelength WCS."""
    hdulist = ufits.open(filename)
    hdu = None
    if ext is None:
        for h in hdulist:  # try to find SCI extension
            if str(h.header.get("EXTNAME", "")).strip() == "SCI":
                hdu = h
                break
        else:
            for h in hdulist:
                if h.data is not None:
                    hdu = h
                    break
            else:
                raise Exception("no extensions have any data")
    else:
        if isinstance(ext, str):
            hdu = next(h for h in hdulist
                       if str(h.header.get("EXTNAME", "")).strip() == ext)
        else:
            hdu = hdulist[ext]
    data = hdu.data
    hdr = hdu.header
    if hdu.is_table:
        wl = data["wavelength"]
        flux = data["flux"]
    else:
        arr = np.asarray(data)
        arr = np.moveaxis(arr, np.arange(arr.ndim), np.argsort(arr.shape))
        flux = arr.flatten()[: max(arr.shape)]
        wl = ufits.linear_wavelength(hdr, len(flux))
    if header:
        return wl, flux, hdr
    return wl, flux


_FLAM = "erg / (Angstrom cm2 s)"


def _parse_flux_unit(bunit):
    """Scale factor and kind ('flam'|'fnu') for a flux-unit string."""
    s = str(bunit).strip()
    m = re.match(r"^\s*(10(?:\*\*|[*^])?\(?-?\d+\)?|1e-?\d+|\d+(\.\d+)?[eE]-?\d+)\s*(.*)$", s)
    scale = 1.0
    if m and m.group(3):
        token = m.group(1).replace("10**", "1e").replace("10^", "1e").replace(
            "10*", "1e").replace("(", "").replace(")", "")
        try:
            scale = float(token)
            s = m.group(3)
        except ValueError:
            pass
    low = s.lower().replace("**", "").replace("^", "").replace(" ", "")
    if "jy" in low:
        factor = 1e-26 if low.startswith("jy") else 1e-29  # Jy or mJy in W/m2/Hz
        return scale * factor, "fnu"
    if "hz" in low:
        # W m-2 Hz-1 (or erg s-1 cm-2 Hz-1)
        factor = 1e-3 if "erg" in low else 1.0  # erg/s/cm2/Hz = 1e-3 W/m2/Hz
        return scale * factor, "fnu"
    # default: erg s-1 cm-2 A-1 family
    return scale, "flam"


def convert_spectrum_units(wl, flux, hdr, default_bunit="erg / (Angstrom cm2 s)",
                           default_cunit="Angstrom"):
    """Convert a spectrum to angstroms and erg/(s cm2 angstrom) using BUNIT and
    CUNIT1/XUNITS when present (reference speccal.py:105-143)."""
    bunit = hdr.get("BUNIT", default_bunit) if hasattr(hdr, "get") else default_bunit
    if bunit in (None, "", "adu", "ADU", "counts", "Counts", "DN"):
        bunit = default_bunit
    cunit = hdr.get("CUNIT1", hdr.get("XUNITS", default_cunit)) if hasattr(hdr, "get") \
        else default_cunit
    if cunit is None:
        cunit = default_cunit
    cunit = str(cunit).strip().lower().rstrip("s") or "angstrom"
    wl = np.asarray(wl, float)
    wl_aa = {"angstrom": 1.0, "a": 1.0, "aa": 1.0, "nm": 10.0, "um": 1e4,
             "micron": 1e4, "micrometer": 1e4, "m": 1e10, "pixel": 1.0,
             "deg": 1.0}.get(cunit, 1.0) * wl

    scale, kind = _parse_flux_unit(bunit)
    flux = np.asarray(flux, float) * scale
    if kind == "fnu":
        # F_lambda = F_nu * c / lambda^2 ; c in angstrom/s = 2.998e18
        flux = flux * (C_M_S * 1e10) / wl_aa ** 2  # W/m2/Hz -> W/m2/A
        flux = flux * 1e7 / 1e4                     # W/m2/A -> erg/s/cm2/A
    return wl_aa, flux


def readOSCspec(filepath):
    """Read spectra from an Open-Astronomy-Catalog JSON file (reference
    speccal.py:146-194)."""
    with open(filepath) as f:
        json_dict = json.load(f)
    rows = json_dict[os.path.splitext(os.path.basename(filepath))[0]]
    if "spectra" in rows:
        rows = rows["spectra"]
    else:
        return [], [], [], [], [], [], []
    keys = set()
    for d in rows:
        keys.update(d.keys())
    superdict = {key: [d.get(key, "0") for d in rows] for key in keys}
    times = [Time(float(t), format=un.lower())
             for t, un in zip(superdict["time"], superdict["u_time"])]
    wl = [0.1 * np.array(d, dtype=float)[:, 0] for d in superdict["data"]]
    fx = [np.array(d, dtype=float)[:, 1] for d in superdict["data"]]
    tel = superdict.get("telescope", [""] * len(rows))
    inst = superdict.get("instrument", [""] * len(rows))
    return superdict["filename"], times, tel, inst, wl, fx, np.ones(len(rows))


# ---------------------------------------------------------------------------
# observation-date heuristics: an ordered strategy table tried until one
# parses (behavioral spec: reference speccal.py:243-299)
# ---------------------------------------------------------------------------

def _parse_mjd_card(hdr, kwd, val):
    return Time(float(val), format="mjd")


def _parse_jd_card(hdr, kwd, val):
    jd = float(val)
    # two-digit-truncated JDs (e.g. 57500.2) are actually reduced JDs
    return Time(jd if jd > 2400000 else jd + 2400000, format="jd")


def _parse_datetime_card(hdr, kwd, val):
    text = str(val)
    if "T" in text:
        return Time(val)
    if kwd == "OBS_DATE":
        return Time(text.split("+")[0])
    if "-" not in text:
        raise ValueError(f"{val!r} is not a date")
    # a bare date: look for a time-of-day card to append
    for time_kwd in ("UTMIDDLE", "EXPSTART", "UT"):
        tod = hdr.get(time_kwd) if hasattr(hdr, "get") else None
        if isinstance(tod, str) and ":" in tod:
            return Time(text + "T" + tod)
        if tod is not None:
            hours = float(tod)
            hms = "{:02d}:{:02d}:{:02d}".format(
                int(hours), int(hours * 60) % 60, int(hours * 3600) % 60)
            return Time(text + "T" + hms)
    return Time(text)


_HEADER_DATE_CARDS = [
    ("MJD-OBS", _parse_mjd_card), ("MJD_OBS", _parse_mjd_card), ("MJD", _parse_mjd_card),
    ("JD", _parse_jd_card),
    ("DATE-AVG", _parse_datetime_card), ("UTMIDDLE", _parse_datetime_card),
    ("DATE-OBS", _parse_datetime_card), ("DATE_BEG", _parse_datetime_card),
    ("UTSHUT", _parse_datetime_card), ("OBS_DATE", _parse_datetime_card),
    ("AVE_MJD", _parse_mjd_card),
]


def _date_from_header(hdr):
    for kwd, parse in _HEADER_DATE_CARDS:
        if kwd not in hdr or not hdr[kwd]:
            continue
        try:
            return parse(hdr, kwd, hdr[kwd])
        except (ValueError, TypeError):
            continue
    return None


def _filename_jd(match):
    return Time(float(match.group()), format="jd")


def _filename_tns(match):
    day, clock = match.group().split("_")
    return Time(day + "T" + clock.replace("-", ":"))


def _filename_isodate(match):
    year, month, day, frac = match.groups()
    date = Time("-".join((year, month, day)))
    return date + float(frac) if frac is not None else date


def _filename_mjd3(match):
    return Time(float(match.group()[:-1]), format="mjd")


def _filename_mjd5(match):
    return Time(float(match.group()), format="mjd")


_FILENAME_DATE_PATTERNS = [
    (r"24[0-9][0-9][0-9][0-9][0-9]\.[0-9]+", _filename_jd),
    (r"(19|20)[0-9][0-9]-(0[0-9]|1[0-2])-(0[1-9]|[12][0-9]|3[01])"
     r"_([01][0-9]|2[0-4])-[0-5][0-9]-[0-5][0-9]", _filename_tns),
    (r"([12][90][0-9][0-9])-?(0[0-9]|1[0-2])-?(0[1-9]|[12][0-9]|3[01])(\.[0-9]+)?",
     _filename_isodate),
    (r"[0-9][0-9][0-9]d", _filename_mjd3),
    (r"[0-9][0-9][0-9][0-9][0-9](\.[0-9]+)?", _filename_mjd5),
]


def _date_from_filename(filename):
    for pattern, build in _FILENAME_DATE_PATTERNS:
        match = re.search(pattern, filename)
        if match is not None:
            return build(match)
    return None


def _first_header_string(hdr, keys):
    for k in keys:
        v = hdr.get(k) if hasattr(hdr, "get") else None
        if v:
            return str(v).strip()
    return ""


def _read_raw_spectrum(f):
    """Dispatch on extension: FITS, OSC JSON, or ASCII with '# key = value'
    comment headers."""
    ext = os.path.splitext(f)[1]
    if ext == ".fits":
        return readfitsspec(f, header=True)
    if ext == ".json":
        # readOSCspec returns per-spectrum LISTS; this helper's contract is
        # one (x, y, hdr). Take the first spectrum and map its OSC metadata
        # onto the header cards the downstream date/unit heuristics read.
        names, times, tel, inst, wl, fx, _ = readOSCspec(f)
        if not len(times):
            raise ValueError(f"no spectra found in OSC file {f}")
        hdr = {"MJD-OBS": times[0].mjd, "TELESCOP": tel[0],
               "INSTRUME": inst[0], "CUNIT1": "nm"}  # readOSCspec emits nm
        return np.asarray(wl[0], float), np.asarray(fx[0], float), hdr
    t = Table.read(f, format="ascii")
    hdr = {}
    for line in t.meta.get("comments", []):
        match = re.search("([^ ]*) *[=:] *([^/]*)", line)
        if match is not None:
            kwd, val = match.groups()
            hdr[kwd.strip(" #")] = val.strip(" \"'")
    return (np.asarray(t[t.colnames[0]], float),
            np.asarray(t[t.colnames[1]], float), hdr)


def readspec(f, verbose=False, return_header=False):
    """Read a spectrum and identify when/where it was observed: header date
    cards first, then filename patterns (behavioral spec: reference
    speccal.py:197-327)."""
    x, y, hdr = _read_raw_spectrum(f)
    date = _date_from_header(hdr)
    if date is None:
        date = _date_from_filename(f)
    telescope = _first_header_string(hdr, ("TELESCOP", "TELESCOPE", "OBSERVAT"))
    instrument = _first_header_string(hdr, ("INSTRUME", "INSTRUMENT", "INSTR",
                                            "INSTRUMENT_ID"))
    x, y = convert_spectrum_units(x, y, hdr)
    if verbose:
        print(date.isot if date else "????", f)
    if return_header:
        return x, y, date, telescope, instrument, hdr
    return x, y, date, telescope, instrument


def _spectrum_to_fnu(wl, flux, subtract_percentile=None):
    """(wavelength [A], F_lambda [erg/s/cm2/A]) -> frequency-ascending
    (nu [THz], F_nu [W/m2/Hz]), dropping NaN fluxes."""
    good = ~np.isnan(flux)
    lam = wl[good]
    nu = C_AA_THZ / lam
    # F_nu = F_lambda * lambda / nu; cgs -> SI is 1e-7 J/erg over 1e-4 m2/cm2
    fnu = flux[good] * 1e-3 * lam / (nu * 1e12)
    nu, fnu = nu[::-1], fnu[::-1]
    if subtract_percentile is not None:
        fnu = fnu - np.nanpercentile(fnu, subtract_percentile)
    return good, nu, fnu


def _sorted_transmission(filt):
    """The filter's normalized transmission on a frequency-ascending grid."""
    freq = np.asarray(filt.trans["freq"], float)
    tnorm = np.asarray(filt.trans["T_norm_per_freq"], float)
    order = np.argsort(freq)
    return freq[order], tnorm[order]


def _band_scale_ratio(filt, lc, trans, nu, fnu, mjd, max_extrapolate):
    """Photometric/synthetic flux ratio for one band at the spectrum's MJD,
    or None (with a printed reason) when the band can't constrain it."""
    lo = filt.freq_eff.value - filt.freq_range[0]
    hi = filt.freq_range[1] + filt.freq_eff.value
    if hi < nu.min() or lo > nu.max():
        print(filt, "and spectrum don't overlap")
        return None
    criteria = {"nondet": False} if "nondet" in lc.colnames else {}
    obs = lc.where(filter=filt, **criteria)
    mjds = np.asarray(obs["MJD"], float) if len(obs) else np.array([])
    if len(obs) == 0 or mjd - mjds.max() > max_extrapolate or mjd < mjds.min():
        print(filt, "not observed before and after spectrum")
        return None
    flux_lc = np.interp(mjd, mjds, np.asarray(obs["flux"], float))
    t_on_spec = np.interp(nu, *trans)
    flux_spec = np.trapezoid(fnu * t_on_spec, nu) / np.trapezoid(t_on_spec, nu)
    return flux_lc / flux_spec, lo, hi, flux_lc


def calibrate_spectra(spectra, lc, filters=None, order=0, subtract_percentile=None,
                      max_extrapolate=1.0, show=False):
    """Calibrate spectra to an observed light curve; write ``photcal_*.txt``
    files (behavioral spec: reference speccal.py:330-439). Per spectrum: the
    mean photometric/synthetic flux ratio over usable bands sets the scale,
    optionally warped by a polynomial in frequency when ``order`` >= 1; in
    interactive mode each scale must be accepted before writing."""
    if filters is not None:
        lc = lc.where(filter=filters)
    lc.calcFlux()
    lc.sort("MJD")
    transmissions = {filt: _sorted_transmission(filt) for filt in set(lc["filter"])}

    import matplotlib.pyplot as plt
    if show:
        plt.ion()
    fig = plt.figure(figsize=(8.0, 6.0))

    for spec in spectra:
        wl, flux, time, _, _ = readspec(spec)
        mjd = time.mjd
        if show:
            fig.clf()
            ax1 = plt.subplot(211)
            lc.plot(xcol="MJD", ycol="flux", offset_factor=0)
            ax1.axvline(mjd)
            ax1.set_xlabel("MJD")
            ax1.set_ylabel("$F_\\nu$ (W Hz$^{-1}$)")
            ax2 = plt.subplot(212)
        good, nu, fnu = _spectrum_to_fnu(wl, flux, subtract_percentile)

        freqs = []
        ratios = []
        for filt, trans in transmissions.items():
            result = _band_scale_ratio(filt, lc, trans, nu, fnu, mjd, max_extrapolate)
            if result is None:
                continue
            ratio, lo, hi, flux_lc = result
            ratios.append(ratio)
            freqs.append(filt.freq_eff.value)
            if show:
                ax2.axvspan(lo, hi, color=filt.color, alpha=0.2)
                ax2.plot(filt.freq_eff.value, flux_lc, marker="o", zorder=5,
                         **filt.plotstyle)
        if not ratios:
            print("no filters for", spec)
            if show:
                plt.close(fig)
            continue

        scale = np.mean(ratios)
        if order:
            warp = np.polyfit(freqs, np.array(ratios) / scale, order)
            corr = np.polyval(warp, nu) * scale
            print(spec, scale, warp[:-1])
        else:
            corr = np.array([scale])
            print(spec, scale)

        if show:
            ax2.plot(nu, fnu * scale, label="rescaled")
            ax2.set_xlabel("Frequency (THz)")
            ax2.set_ylabel("$F_\\nu$ (W Hz$^{-1}$)")
            if order:
                ax2.plot(nu, fnu * corr, color="C2", label="rescaled & warped")
                plt.legend(loc="best")
            plt.pause(0.1)
            if input("accept this scale? [Y/n] ").lower() == "n":
                continue
        path_in, filename_in = os.path.split(spec)
        outfile = os.path.join(path_in, "photcal_" + filename_in).replace(".fits", ".txt")
        np.savetxt(outfile, np.column_stack([wl[good], flux[good] * corr[::-1]]),
                   fmt="%.1f %.2e")
        print(outfile)
    if show:
        return fig
    plt.close(fig)


_WISEREP_COLUMNS = [
    "Ascii-filename*", "FITS-filename*", "Obs-date* [YYYY-MM-DD HH:MM:SS] / JD",
    "Instrument-Id*", "Exp-time (sec)", "WL Units-id", "WL Medium-Id",
    "Flux Unit Coeff", "Flux Units-Id", "Flux Calib. By-Id",
    "Extinction-Corrected-Id", "Observer/s      ", "Reducer/s   ",
    "Reduction-date [YYYY-MM-DD HH:MM:SS] / JD", "Aperture (Slit)", "Dichroic",
    "Grism", "Grating", "Blaze", "Airmass", "Hour Angle", "Spec Type-Id",
    "Spec Quality-Id", "Spec. Prop-period value", "Prop-period units",
    "Assoc. Groups", "Spec-Remarks", "Publish (bibcode)", "Contrib",
    "Related-file1", "RF1 Comments", "Related-file2", "RF2 Comments",
]

_WISEREP_DEFAULTS_LINE = ("\t\t\t\tNULL\t[default=11 (Angstrom)]\t[default=1 (Air)]\t[default=1.0]"
                          "\t[default=6]\tNULL\tNULL\t[Unknown]\tNULL\tNULL\tNULL\tNULL\tNULL\tNULL"
                          "\tNULL\tNULL\tNULL\t[default=10=Object]\tNULL\tNULL\t[days/months/years]"
                          "\t[Comma delim.]\tNULL\tNULL\tNULL\tNULL\tNULL\tNULL\tNULL")


_WL_UNIT_IDS = {"angstrom": 11, "nm": 12, "um": 13}


def _header_card(hdr, key, cast=None):
    value = hdr.get(key) if hasattr(hdr, "get") else None
    if value is None or value == "":
        return None
    return cast(value) if cast else value


def _wiserep_record(ascii_file, specfile, date, inst_id, hdr, groups, bibcode,
                    quality, date_fmt):
    """One upload row as a column-name -> value mapping (serialized in
    ``_WISEREP_COLUMNS`` order). Unspecified columns default to None/NULL."""
    cunit = str(_header_card(hdr, "CUNIT1") or _header_card(hdr, "XUNITS")
                or "angstrom").lower()
    if date is not None:
        date_str = date.iso if date_fmt == "iso" else f"{date.jd:.5f}"
    else:
        date_str = None
    record = dict.fromkeys(_WISEREP_COLUMNS)
    record.update({
        "Ascii-filename*": ascii_file,
        "FITS-filename*": specfile if specfile.endswith(".fits") else None,
        "Obs-date* [YYYY-MM-DD HH:MM:SS] / JD": date_str,
        "Instrument-Id*": inst_id,
        "Exp-time (sec)": _header_card(hdr, "exptime") or _header_card(hdr, "EXPTIME"),
        "WL Units-id": _WL_UNIT_IDS.get(cunit, 11),
        "WL Medium-Id": 1,
        "Flux Unit Coeff": 1.0,
        "Flux Units-Id": 6,
        "Flux Calib. By-Id": 2 if specfile.startswith("photcal") else 1,
        "Extinction-Corrected-Id": 0,
        "Observer/s      ": _header_card(hdr, "OBSERVER") or "Unknown",
        "Reducer/s   ": _header_card(hdr, "REDUCER"),
        "Aperture (Slit)": _header_card(hdr, "APERWID", float),
        "Dichroic": _header_card(hdr, "DICHROIC"),
        "Grism": _header_card(hdr, "GRISM"),
        "Grating": _header_card(hdr, "GRATING"),
        "Blaze": _header_card(hdr, "BLAZE", float),
        "Airmass": _header_card(hdr, "AIRMASS", float),
        "Hour Angle": _header_card(hdr, "HA") or None,
        "Spec Type-Id": 10,
        "Spec Quality-Id": quality,
        "Spec. Prop-period value": 0.0,
        "Prop-period units": "days",
        "Assoc. Groups": groups,
        "Publish (bibcode)": bibcode or None,
    })
    return record


def _tsv_cell(value):
    if value in (None, "", "None", "UNKNOWN"):
        return "NULL"
    return str(value)


def create_wiserep_tsv(specpaths, wiserep_dir, verbose=False, instruments=None, date_fmt="iso"):
    """Prepare a WISeREP upload TSV and collect/convert the spectrum files
    (behavioral spec: reference speccal.py:442-590). Interactive: prompts for
    the bibcode, per-spectrum group IDs, and unknown instrument IDs."""
    if os.path.exists(wiserep_dir):
        ans = input(f"Are you sure you want to delete the directory {wiserep_dir}? [y/N] ")
        if ans.lower() != "y":
            return
        shutil.rmtree(wiserep_dir)
    os.mkdir(wiserep_dir)

    bibcode = input("bibcode: ")
    instruments = {} if instruments is None else instruments
    records = []
    for specpath in specpaths:
        if isinstance(specpath, tuple):
            specpath, quality = specpath
            quality = min(max(round(quality), 1), 3)
        else:
            quality = 2
        specfile = os.path.split(specpath)[-1]
        ascii_file = specfile.replace(".fits", ".txt").replace(".csv", ".txt")
        print()
        wl, flux, date, tel, inst, hdr = readspec(specpath, verbose=True, return_header=True)
        groups = input("https://www.wiserep.org/groups\ngroup IDs (comma sep.): ")
        if inst in instruments:
            inst_id = instruments[inst]
        else:
            inst_id = input(f"https://www.wiserep.org/aux\nlook up instrument ID for {inst} (required): ")
            if inst and inst_id:
                instruments[inst] = int(inst_id)
        records.append(_wiserep_record(ascii_file, specfile, date, inst_id, hdr,
                                       groups, bibcode, quality, date_fmt))

        if not specfile.endswith(".csv"):
            shutil.copy(specpath, wiserep_dir)
            if verbose:
                print(f"copied {specfile} to {wiserep_dir}")
        if specfile.endswith((".fits", ".csv")):
            np.savetxt(os.path.join(wiserep_dir, ascii_file), np.transpose([wl, flux]),
                       fmt=("%f", "%e"), header=repr(hdr))
            if verbose:
                print(f"wrote {wiserep_dir}/{ascii_file}")

    lines = ["TSV-type:\tspectra",
             "\t".join(_WISEREP_COLUMNS),
             _WISEREP_DEFAULTS_LINE]
    lines += ["\t".join(_tsv_cell(rec[col]) for col in _WISEREP_COLUMNS)
              for rec in records]
    with open(wiserep_dir + ".tsv", "w") as f:
        f.write("\n".join(lines) + "\n")
    if verbose:
        print(f"\nwrote {wiserep_dir}.tsv")

    if not records:
        return None
    return Table(rows=[[rec[col] for col in _WISEREP_COLUMNS] for rec in records],
                 names=_WISEREP_COLUMNS)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Calibrate spectra to photometry.")
    parser.add_argument("spectra", nargs="+", help="filenames of spectra")
    parser.add_argument("--lc", help='filename of photometry table (must have columns "MJD", '
                                     '"filter", "mag"/"flux", and "dmag"/"dflux")')
    parser.add_argument("--lc-format", default="ascii",
                        help="format of photometry table")
    parser.add_argument("-f", "--filters", nargs="+", help="filters to use for calibration")
    parser.add_argument("-o", "--order", type=int, default=0,
                        help="polynomial order of correction function")
    parser.add_argument("--subtract-percentile", type=float,
                        help="subtract continuum from spectrum before correcting")
    parser.add_argument("--max-extrapolate", type=float, default=1.0,
                        help="assume constant flux in a filter for this many days after the "
                             "last observed point")
    parser.add_argument("--show", action="store_true")
    args = parser.parse_args(argv)

    lc = LC.read(args.lc, format=args.lc_format)
    calibrate_spectra(args.spectra, lc, args.filters, args.order, args.subtract_percentile,
                      args.max_extrapolate, args.show)


if __name__ == "__main__":
    main()
