"""Light-curve container and photometric conversions.

Host-side data layer covering the behavior of the reference
``lightcurve_fitting/lightcurve.py``: the :class:`LC` table with ~60
recognized column aliases, a row-selection DSL, mag/flux/absmag/luminosity
conversions with 3-sigma nondetection handling, inverse-variance time
binning, peak/phase utilities, and the multiband matplotlib plot with
nondetection arrows and stacked legends. Built on the framework's own table
layer (astropy is not a dependency).

The implementation is organised around three small engines of our own:

* a **criteria engine** (:func:`_criterion`, :func:`_criterion_mask`) that
  parses ``where()`` keywords into (column, relation, value) triples and
  evaluates each as a boolean mask (behavioral spec:
  reference lightcurve.py:87-134);
* **conversion kernels** (:func:`flux2mag`, :func:`mag2flux`) expressed
  through a shared masked-float coercion (:func:`_as_float_masked`) and
  ``np.ma.where`` nondetection substitution (spec: reference
  lightcurve.py:878-941);
* a **plot styling resolver** (:class:`_StyleBook`) that maps each plotted
  group to its color/marker/edge styles, keeping :meth:`LC.plot` itself an
  orchestration loop (spec: reference lightcurve.py:419-668).

Device code never touches these objects: fitting extracts plain arrays
(MJD, flux/lum, errors, integer band ids) once per fit.
"""

import itertools
from functools import cache, partial

import numpy as np

from .filters import filtdict
from .utils.table import Table, MaskedColumn, vstack
from .utils.cosmology import Planck18

try:
    from config import markers  # optional user configuration module
except ModuleNotFoundError:
    markers = {}

__all__ = ["LC", "Arrow", "flux2mag", "mag2flux", "binflux", "aux_axes",
           "custom_legend", "filter_legend", "filtsetup", "column_names"]


def Arrow(hx, hy):
    """A downward arrow glyph (a ``matplotlib.path.Path``) used to mark
    nondetections (limiting magnitudes); ``hx``/``hy`` set the head
    half-width and head height (behavioral spec: reference
    lightcurve.py:18-31)."""
    from matplotlib.path import Path
    stem = [(0.0, 0.0), (0.0, -1.0)]
    head = [(-hx, hy - 1.0), (0.0, -1.0), (hx, hy - 1.0), (0.0, -1.0)]
    verts = stem + head + [(0.0, 0.0)]
    codes = [Path.MOVETO] + [Path.LINETO] * (len(verts) - 2) + [Path.CLOSEPOLY]
    return Path(verts, codes)


@cache
def _style_cycles():
    """(other markers, marker cycle, color cycle) shared by every plot in the
    process; built on the first plot so that importing this module (and
    fitting without plots) never imports matplotlib."""
    import matplotlib.pyplot as plt
    from matplotlib.markers import MarkerStyle
    othermarkers = ("o", *MarkerStyle.filled_markers[2:])
    return (othermarkers, itertools.cycle(othermarkers),
            itertools.cycle(plt.rcParams["axes.prop_cycle"].by_key()["color"]))

# recognized column aliases; first entry of each list is the canonical name
# (alias sets per reference lightcurve.py:40-59)
column_names = {
    "Filter": ["filter", "filt", "Filter", "band", "FLT", "Band"],
    "Telescope": ["telescope", "Telescope", "Tel", "tel+inst"],
    "Source": ["source", "Source"],
    "Apparent Magnitude": ["mag", "Magnitude", "Mag", "ab_mag", "PSFmag", "MAG", "omag",
                           "magnitude", "apparent_mag"],
    "Apparent Magnitude Uncertainty": [
        "dmag", "Magnitude_Error", "magerr", "MagErr", "mag_err", "e_mag", "Error", "err",
        "PSFerr", "MAGERR", "e_omag", "e_magnitude", "apparent_mag_err", "Mag_Err", "emag",
        "error",
    ],
    "MJD": ["MJD", "mjd"],
    "JD": ["JD", "jd"],
    "Phase (rest days)": ["phase", "Phase", "PHASE"],
    "Flux $F_ν$ (W m$^{-2}$ Hz$^{-1}$)": ["flux", "FLUXCAL"],
    "Flux Uncertainty": ["dflux", "FLUXCALERR"],
    "Nondetection": ["nondet", "Is_Limit", "UL", "l_omag", "upper_limit", "upperlimit"],
    "Absolute Magnitude": ["absmag"],
    "Luminosity $L_ν$ (W Hz$^{-1}$)": ["lum"],
    "Luminosity Uncertainty": ["dlum"],
    "Effective Wavelength (nm)": ["wl_eff"],
}


def _axis_label_for(colname):
    """Display label for a canonical or aliased column name (None if unknown)."""
    for label, aliases in column_names.items():
        if colname in aliases:
            return label
    return None


# --------------------------------------------------------------------------
# criteria engine backing LC.where
# --------------------------------------------------------------------------

# keyword suffix -> relation; matched by substring as in the reference DSL
_RELATIONS = (("_not", "exclude"), ("_min", "atleast"), ("_max", "atmost"))


def _criterion(key, value):
    """Parse one ``where()`` keyword into ``(column, relation, value)``.

    Relations: 'match' (default), 'exclude', 'atleast', 'atmost'. Values for
    filter columns are looked up in the registry so users can pass strings.
    List values with 'atleast'/'atmost' are not meaningful and keep the raw
    key (matching the reference's lookup failure in that case).
    """
    if key.startswith("filter"):
        if isinstance(value, str):
            value = filtdict[value]
        elif isinstance(value, list):
            value = [filtdict[v] if isinstance(v, str) else v for v in value]

    if isinstance(value, list):
        if "_not" in key:
            return key.replace("_not", ""), "exclude", value
        return key, "match", value

    for suffix, relation in _RELATIONS:
        if suffix in key:
            return key.replace(suffix, ""), relation, value
    return key, "match", value


def _criterion_mask(table, column, relation, value):
    """Boolean row mask for one parsed criterion. ``None`` values test
    elementwise identity (the table layer stores object columns)."""
    data = table[column]
    if relation == "atleast":
        return np.asarray(data >= value)
    if relation == "atmost":
        return np.asarray(data <= value)

    values = value if isinstance(value, list) else [value]
    hit = np.zeros(len(table), bool)
    for v in values:
        if v is None:
            hit |= np.array([row is None for row in data])
        else:
            hit |= np.ma.filled(np.ma.MaskedArray(data == v), False)
    return ~hit if relation == "exclude" else hit


class LC(Table):
    """A broadband light curve (behavior of reference lightcurve.py:62-688)."""

    def __init__(self, *args, **kwargs):
        Table.__init__(self, *args, **kwargs)
        self.normalize_column_names()
        if "filter" in self.colnames and self["filter"].dtype.kind != "O":
            self.filters_to_objects()
        oldlc = args[0] if args else None
        self.nondetSigmas = getattr(oldlc, "nondetSigmas", 3.0)
        self.groupby = getattr(oldlc, "groupby", {"filter", "source"}).copy()
        self.markers = getattr(oldlc, "markers", markers).copy()
        self.colors = getattr(oldlc, "colors", {}).copy()

    def _copy_attrs(self, new):
        new.nondetSigmas = getattr(self, "nondetSigmas", 3.0)
        new.groupby = getattr(self, "groupby", {"filter", "source"}).copy()
        new.markers = getattr(self, "markers", {}).copy()
        new.colors = getattr(self, "colors", {}).copy()

    # ------------------------------------------------------------- selection
    def where(self, **kwargs):
        """Select rows matching all criteria. Keywords are ``col=value``
        (match), ``col_not=`` (exclude), ``col_min=`` (>=), ``col_max=``
        (<=); list values mean "any of" / "none of". Filter criteria accept
        registry names. (DSL spec: reference lightcurve.py:87-134.)"""
        keep = np.ones(len(self), bool)
        for key, raw in kwargs.items():
            keep &= _criterion_mask(self, *_criterion(key, raw))
        selected = self[keep]
        selected.markers = self.markers  # share the marker assignments
        return selected

    def get(self, key, default=np.ma.masked):
        if key in self.colnames:
            return MaskedColumn(self[key])
        if default is np.ma.masked:
            return MaskedColumn(np.ma.MaskedArray(np.zeros(len(self)), mask=True), name=key)
        return MaskedColumn(np.ma.MaskedArray(np.tile(default, len(self))), name=key)

    # --------------------------------------------------------- normalization
    def normalize_column_names(self):
        """Rename recognized aliases to canonical names; derive MJD from JD;
        parse nondetection flag strings (spec: reference
        lightcurve.py:144-161)."""
        for canonical, *aliases in column_names.values():
            if canonical in self.colnames:
                continue
            hit = next((a for a in aliases if a in self.colnames), None)
            if hit is not None:
                self.rename_column(hit, canonical)
        if "MJD" not in self.colnames and "JD" in self.colnames:
            self["MJD"] = self["JD"] - 2400000.5
            self.remove_column("JD")
        if "nondet" in self.colnames and self["nondet"].dtype.kind != "b":
            col = self["nondet"]
            if isinstance(col, np.ma.MaskedArray):
                col = col.filled("False" if col.dtype.kind in "UO" else 0)
            flags = np.asarray(col).astype(str)
            self.replace_column("nondet", np.isin(flags, ("True", "T", ">")))

    def filters_to_objects(self):
        """Parse the 'filter' column into Filter objects, including the Swift
        U/B/V disambiguation (spec: reference lightcurve.py:163-180)."""
        filters = np.array([filtdict["0"] if np.ma.is_masked(f) or f is None
                            else filtdict.get(str(f), filtdict["?"])
                            for f in self["filter"]], dtype=object)
        is_swift = np.zeros(len(self), bool)
        if "telescope" in self.colnames:
            tel = np.asarray(self["telescope"]).astype(str)
            is_swift |= np.isin(tel, ("Swift", "UVOT", "Swift/UVOT", "Swift+UVOT"))
        if "source" in self.colnames:
            is_swift |= np.asarray(self["source"]).astype(str) == "SOUSA"
        if is_swift.any():
            raw = np.asarray(self["filter"]).astype(str)
            for filt, swiftfilt in zip("UBV", "sbv"):
                filters[is_swift & (raw == filt)] = filtdict[swiftfilt]
        self.replace_column("filter", filters)

    # ------------------------------------------------------------ conversions
    @property
    def zp(self):
        return np.array([f.m0 for f in self["filter"]])

    def calcFlux(self, nondetSigmas=None, zp=None):
        if nondetSigmas is not None:
            self.nondetSigmas = nondetSigmas
        if zp is None:
            zp = self.zp
        self["flux"], self["dflux"] = mag2flux(self["mag"], self["dmag"], zp,
                                               self.get("nondet", False), self.nondetSigmas)

    def findNondet(self, nondetSigmas=None):
        if nondetSigmas is not None:
            self.nondetSigmas = nondetSigmas
        self["nondet"] = np.asarray(self["flux"] < self.nondetSigmas * self["dflux"])

    def calcMag(self, nondetSigmas=None, zp=None):
        if nondetSigmas is not None:
            self.nondetSigmas = nondetSigmas
        self.findNondet()
        if zp is None:
            zp = self.zp
        self["mag"], self["dmag"] = flux2mag(self["flux"], self["dflux"], zp,
                                             self.get("nondet", False), self.nondetSigmas)

    def calcAbsMag(self, dm=None, extinction=None, hostext=None, ebv=None, rv=None,
                   host_ebv=None, host_rv=None, redshift=None):
        """Distance and extinction corrections (spec: reference
        lightcurve.py:271-345): distance modulus from Planck18 if only a
        redshift is known; MW and host F99 A_lambda per filter at its
        effective wavelength."""
        if redshift is not None:
            self.meta["redshift"] = redshift
        elif "redshift" not in self.meta:
            self.meta["redshift"] = 0.0

        if dm is not None:
            self.meta["dm"] = dm
        elif "dm" not in self.meta and self.meta.get("redshift"):
            self.meta["dm"] = Planck18.distmod(self.meta["redshift"]).value
            print("using a redshift-dependent distance modulus")
        elif "dm" not in self.meta:
            self.meta["dm"] = 0.0

        if ebv is None:
            ebv = self.meta.get("ebv")
        if host_ebv is None:
            host_ebv = self.meta.get("host_ebv")
        if rv is None:
            rv = self.meta.get("rv", 3.1)
        if host_rv is None:
            host_rv = self.meta.get("host_rv", 3.1)

        if extinction is not None:
            self.meta["extinction"] = extinction
        elif "extinction" not in self.meta:
            self.meta["extinction"] = {f.name: f.extinction(ebv, rv)
                                       for f in set(self["filter"])
                                       if f.wl_eff is not None and ebv is not None}
        if hostext is not None:
            self.meta["hostext"] = hostext
        elif "hostext" not in self.meta:
            self.meta["hostext"] = {f.name: f.extinction(host_ebv, host_rv, self.meta.get("z", 0.0))
                                    for f in set(self["filter"])
                                    if f.wl_eff is not None and host_ebv is not None}

        self["absmag"] = np.ma.getdata(np.asarray(self["mag"])) - self.meta["dm"]
        for filtobj in set(self["filter"]):
            sel = np.asarray(self["filter"] == filtobj)
            for correction in ("extinction", "hostext"):
                table = self.meta[correction]
                known = next((n for n in filtobj.names if n in table), None)
                if known is not None:
                    self["absmag"][sel] -= table[known]
                else:
                    kind = "MW" if correction == "extinction" else "host"
                    print(f"{kind} extinction not applied to filter", filtobj)

    def calcLum(self, nondetSigmas=None):
        if nondetSigmas is not None:
            self.nondetSigmas = nondetSigmas
        self["lum"], self["dlum"] = mag2flux(self["absmag"], self["dmag"], self.zp + 90.19,
                                             self.get("nondet", False), self.nondetSigmas)

    # -------------------------------------------------------------- binning
    def _bin_one_group(self, group, key, delta):
        """Bin one {filter, source} group and re-attach its key columns."""
        mjd, flux, dflux = binflux(group["MJD"], group["flux"], group["dflux"], delta)
        binned = LC([mjd, flux, dflux], names=["MJD", "flux", "dflux"])
        for col in (self.groupby if key is not None else ()):
            binned[col] = key[col]
        return binned

    def bin(self, delta=0.3, groupby=None):
        """Average points within ``delta`` days, grouped by {filter, source}
        (spec: reference lightcurve.py:206-238)."""
        self.groupby = list(set(groupby if groupby is not None else self.groupby)
                            & set(self.colnames))
        if self.groupby:
            grouped = self.group_by(self.groupby)
            pairs = list(zip(grouped.groups, grouped.groups.keys))
        else:
            pairs = [(self, None)]
        stacked = vstack([self._bin_one_group(g, k, delta) for g, k in pairs])
        out = stacked if isinstance(stacked, LC) else LC(stacked)
        out.meta = self.meta
        return out

    # ------------------------------------------------------------ peak/phase
    def findPeak(self, **criteria):
        if "nondet" in self.colnames:
            criteria["nondet"] = False
        peaktable = self.where(**criteria)
        if len(peaktable):
            imin = np.argmin(peaktable["mag"])
            self.meta["peakdate"] = float(peaktable["MJD"][imin])
            self.meta["peakcriteria"] = criteria
        else:
            print(f"no data match these criteria: {criteria}")

    def calcPhase(self, rdsp=False, hours=False):
        if "refmjd" not in self.meta:
            if rdsp and self.meta.get("peakdate") is None:
                raise Exception("must run lc.findPeak() first")
            elif rdsp:
                self.meta["refmjd"] = self.meta["peakdate"]
            elif self.meta.get("explosion") is not None:
                self.meta["refmjd"] = self.meta["explosion"]
            else:
                detections = self.where(nondet=False) if "nondet" in self.colnames else self
                self.meta["refmjd"] = float(np.min(np.asarray(detections["MJD"])))
        self["phase"] = (np.asarray(self["MJD"], float) - self.meta["refmjd"]) \
            / (1 + self.meta["redshift"])
        for dcol in ["dMJD", "dMJD0", "dMJD1"]:
            if dcol in self.colnames:
                self[dcol.replace("MJD", "phase")] = self[dcol] / (1.0 + self.meta["redshift"])
        if hours:
            self["phase"] = self["phase"] * 24.0
            for dcol in ["dphase0", "dphase1"]:
                if dcol in self.colnames:
                    self[dcol] = self[dcol] * 24.0

    # -------------------------------------------------------------- plotting
    def _resolve_plot_columns(self, xcol, ycol):
        """Map the requested axes onto available columns, materializing
        wl_eff when the x-axis is the filter itself; fall back through
        phase->MJD and absmag->mag."""
        if xcol.startswith("filter"):
            unit = xcol.split(":")[-1] if ":" in xcol else None
            xcol = "wl_eff"
            self[xcol] = [f.wl_eff.to(unit).value if unit else f.wl_eff.value
                          for f in self["filter"]]
        for requested, fallbacks, axis in ((xcol, ["phase", "MJD"], "x"),
                                           (ycol, ["absmag", "mag"], "y")):
            if requested not in self.keys():
                # only the documented fallback chains substitute silently
                # (phase -> MJD, absmag -> mag); an unrecognized column is a
                # loud error, as in the reference (lightcurve.py:497-509)
                if requested not in fallbacks:
                    raise Exception(f'no columns found for {axis}-axis ("{requested}")')
                # the reference falls back in BOTH directions within the
                # recognized pair (phase <-> MJD, absmag <-> mag,
                # lightcurve.py:497-509): try the others in chain order
                chain = [c for c in fallbacks if c != requested]
                requested = next((c for c in chain if c in self.keys()), None)
                if requested is None:
                    raise Exception(f"no columns found for {axis}-axis")
            if axis == "x":
                xcol = requested
            else:
                ycol = requested
        return xcol, ycol

    def plot(self, xcol="phase", ycol="absmag", offset_factor=1.0, color="filter",
             marker=None, use_lines=False, normalize=False, fillmark=True, mjd_axis=True,
             appmag_axis=True, loc_mark=None, loc_filt=None, ncol_mark=1, lgd_filters=None,
             tight_layout=True, phase_hours=False, return_axes=False, frameon=True, **kwargs):
        """Multiband light-curve plot with nondetection arrows, per-filter
        colors/offsets, twin MJD/apparent-mag axes, and 'above' legends
        (behavioral spec: reference lightcurve.py:419-668). Style choices per
        group are delegated to :class:`_StyleBook`."""
        import matplotlib.pyplot as plt
        xcol, ycol = self._resolve_plot_columns(xcol, ycol)
        if marker is None:
            marker = next((c for c in ("source", "telescope") if c in self.colnames), "o")

        criteria = {key: val for key, val in kwargs.items() if key in self.colnames}
        extra_kwargs = {key: val for key, val in kwargs.items() if key not in self.colnames}
        plottable = self.where(**criteria)
        if len(plottable) == 0:
            return

        group_cols = sorted({c for c in (color, marker) if c in plottable.keys()})
        if group_cols:
            plottable = plottable.group_by(group_cols)
            groups, keys = plottable.groups, plottable.groups.keys
        else:
            groups, keys = [plottable], [Table()]

        book = _StyleBook(self, color, marker, fillmark, plottable.keys())
        book.prime(groups)
        linestyle = extra_kwargs.pop("linestyle", extra_kwargs.pop(
            "ls", self.meta.get("linestyle", self.meta.get("ls"))))
        linewidth = extra_kwargs.pop("linewidth", extra_kwargs.pop(
            "lw", self.meta.get("linewidth", self.meta.get("lw"))))
        ms = extra_kwargs.pop("markersize",
                              extra_kwargs.pop("ms", plt.rcParams["lines.markersize"]))

        for g, k in zip(groups, keys):
            filt = g["filter"][0]
            col, mec, mfc, mark = book.resolve(g)
            yerr = None
            if use_lines:
                g.sort(xcol)
            elif "mag" in ycol:
                yerr = g["dmag"]
            else:
                yerr = g["d" + ycol]
                if yerr.ndim == 2:
                    yerr = yerr.T
            x = np.ma.filled(np.ma.MaskedArray(g[xcol]), np.nan).astype(float)
            xerr = g["d" + xcol] if "d" + xcol in g.colnames else None
            if xerr is not None and xerr.ndim == 2:
                xerr = xerr.T
            y = np.ma.filled(np.ma.MaskedArray(g[ycol]), np.nan).astype(float) \
                - filt.offset * offset_factor
            if normalize:
                peak_key = "peakmag" if ycol == "mag" else "peakabsmag"
                if ycol in ("mag", "absmag"):
                    if peak_key in self.meta:
                        y -= self.meta[peak_key]
                    else:
                        print(f"must set .meta['{peak_key}'] to use normalize")
            nondet = np.asarray(g["nondet"], bool) if "nondet" in g.keys() else None
            if "mag" in ycol and nondet is not None and marker:
                plt.plot(x[nondet], y[nondet], marker=Arrow(0.2, 0.3), linestyle="none",
                         ms=ms / 6.0 * 25.0, mec=mec, **extra_kwargs)
            if hasattr(k, "colnames") and "filter" in k.colnames:
                k["filter"] = _filter_label(filt, offset_factor)
            label = " ".join([str(kv) for kv in (k.values() if hasattr(k, "values") else [])])
            if not use_lines:
                if yerr is not None:
                    yerr = np.ma.filled(np.ma.MaskedArray(yerr), np.nan)
                plt.errorbar(x, y, yerr, xerr=xerr, color=mec, mfc=mfc, mec=mec, ms=ms,
                             marker=mark, linestyle="none", label=label, **extra_kwargs)
            elif "mag" in ycol and nondet is not None:
                plt.plot(x[~nondet], y[~nondet], color=col, mfc=mfc, mec=mec, ms=ms, marker=mark,
                         label=label, linestyle=linestyle, linewidth=linewidth, **extra_kwargs)
                plt.plot(x[nondet], y[nondet], color=mec, mfc=mfc, mec=mec, ms=ms, marker=mark,
                         linestyle="none", **extra_kwargs)
            else:
                plt.plot(x, y, color=col, mfc=mfc, mec=mec, ms=ms, marker=mark, label=label,
                         linestyle=linestyle, linewidth=linewidth, **extra_kwargs)

        self._decorate_plot_axes(xcol, ycol, phase_hours)
        lgd_title = _axis_label_for(marker)

        mjd_axis = mjd_axis and xcol == "phase" and "redshift" in self.meta and "refmjd" in self.meta
        appmag_axis = appmag_axis and ycol == "absmag" and "dm" in self.meta
        axes = [plt.gca()]
        top = right = None
        if mjd_axis or appmag_axis:
            xfunc = partial(self._phase2mjd, hours=phase_hours)
            top, right = aux_axes(xfunc if mjd_axis else None,
                                  self._abs2app if appmag_axis else None)
            if mjd_axis:
                top.xaxis.get_major_formatter().set_useOffset(False)
                top.set_xlabel("MJD")
                axes.append(top)
            if appmag_axis:
                right.set_ylabel("Apparent Magnitude")
                axes.append(right)

        if loc_mark:
            self._marker_legend(axes, marker, color, ms, ncol_mark, loc_mark,
                                lgd_title, frameon)
        if loc_filt:
            self._filter_legend(axes, color, lgd_filters, offset_factor, loc_filt, frameon)

        if tight_layout:
            plt.tight_layout()
        if return_axes and (mjd_axis or appmag_axis):
            return top, right

    def _decorate_plot_axes(self, xcol, ycol, phase_hours):
        """Axis labels from the column registry; magnitude axes increase
        downward."""
        import matplotlib.pyplot as plt
        ymin, ymax = plt.ylim()
        if "mag" in ycol and ymax > ymin:
            plt.ylim(ymax, ymin)
        xlabel = _axis_label_for(xcol)
        if xlabel is not None:
            if xcol == "phase" and phase_hours:
                xlabel = xlabel.replace("days", "hours")
            plt.xlabel(xlabel)
        ylabel = _axis_label_for(ycol)
        if ylabel is not None:
            plt.ylabel(ylabel)

    def _marker_legend(self, axes, marker, color, ms, ncol_mark, loc_mark,
                       lgd_title, frameon):
        if not axes:
            print("cannot create marker legend: not enough axes")
            return
        if marker not in self.colnames:
            print(f'cannot create marker legend: column "{marker}" does not exist')
            return
        # colors/markers are keyed by the RAW column values (_StyleBook.resolve
        # stores group[spec][0] as-is); str-cast only for the display labels,
        # so non-string group values (e.g. integer source IDs) still resolve
        keys = sorted(set(np.asarray(self[marker]).tolist()),
                      key=lambda k: str(k).lower())
        labels = [str(k) for k in keys]
        import matplotlib.pyplot as plt
        lines = []
        for key in keys:
            mec, mfc = ((self.colors.get(key, "k"),) * 2 if marker == color
                        else ("k", "none"))
            lines.append(plt.Line2D([], [], mec=mec, mfc=mfc, ms=ms,
                                    marker=self.markers.get(key, "o"), linestyle="none"))
        custom_legend(axes.pop(), lines, labels, ncol=ncol_mark, loc=loc_mark,
                      title=lgd_title, frameon=frameon)

    def _filter_legend(self, axes, color, lgd_filters, offset_factor, loc_filt, frameon):
        if not axes:
            print("cannot create filter legend: not enough axes")
            return
        if color != "filter":
            return
        if lgd_filters is None:
            lgd_filters = set(self["filter"])
        lines, labels, ncol = filter_legend(lgd_filters, offset_factor)
        custom_legend(axes.pop(), lines, labels, loc=loc_filt, ncol=ncol,
                      title="Filter", frameon=frameon)

    def _phase2mjd(self, phase, hours=False):
        return phase * (1.0 + self.meta["redshift"]) / (24.0 if hours else 1.0) + self.meta["refmjd"]

    def _abs2app(self, absmag):
        return absmag + self.meta["dm"]

    # --------------------------------------------------------------------- IO
    @classmethod
    def read(cls, filepath, format="ascii", fill_values=None, **kwargs):
        if fill_values is None:
            fill_values = [("--", "0"), ("", "0")]
        return super(LC, cls).read(filepath, format=format, fill_values=fill_values, **kwargs)

    def write(self, *args, **kwargs):
        out = Table(self)
        if "filter" in out.colnames:
            out.replace_column("filter", np.array([str(f) for f in self["filter"]]))
        out.write(*args, **kwargs)


def _filter_label(filt, offset_factor):
    """Legend text for a filter entry: long unoffset names stay plain; others
    render in math mode with their plotted offset."""
    if len(filt.name) >= 4 and not filt.offset:
        return filt.name
    if offset_factor:
        return "${}{:+.0f}$".format(filt.name, -filt.offset * offset_factor)
    return "${}$".format(filt.name)


class _StyleBook:
    """Resolves per-group plot styles (face/edge colors and markers) for
    :meth:`LC.plot`, caching assignments on the parent LC so repeated plots
    stay consistent. White face colors get black edges so points stay
    visible."""

    _WHITES = ("w", "#FFFFFF")

    def __init__(self, lc, color_spec, marker_spec, fillmark, available_cols):
        self.lc = lc
        self.color_spec = color_spec
        self.marker_spec = marker_spec
        self.fillmark = fillmark
        self.color_is_column = color_spec in available_cols
        self.marker_is_column = marker_spec in available_cols
        self.used = set()

    def prime(self, groups):
        """Record markers already assigned to any group's key, so new
        assignments don't collide."""
        if not self.marker_is_column:
            return
        for g in groups:
            key = g[self.marker_spec][0]
            if key in self.lc.markers:
                self.used.add(self.lc.markers[key])

    def _edge_for(self, facecolor):
        return "k" if facecolor in self._WHITES else facecolor

    def resolve(self, group):
        """Return (color, edgecolor, facecolor, marker) for one group."""
        from matplotlib.colors import is_color_like
        filt = group["filter"][0]
        spec = self.color_spec
        if spec == "filter":
            col, mec = filt.color, filt.mec
        elif spec == "name" and "plotcolor" in self.lc.meta:
            col = self.lc.meta["plotcolor"]
            mec = self._edge_for(col)
        elif self.color_is_column and group[spec][0] in self.lc.colors:
            col = self.lc.colors[group[spec][0]]
            mec = self._edge_for(col)
        elif is_color_like(spec):
            col = spec
            mec = self._edge_for(col)
        else:
            col = mec = next(_style_cycles()[2])
        if self.color_is_column:
            self.lc.colors[group[spec][0]] = col

        mfc = col if self.fillmark else "none"
        mark = self._marker_for(group)
        self.used.add(mark)
        return col, mec, mfc, mark

    def _marker_for(self, group):
        from matplotlib.markers import MarkerStyle
        othermarkers, itermarkers, _ = _style_cycles()
        spec = self.marker_spec
        if spec == "name" and "marker" in self.lc.meta:
            return self.lc.meta["marker"]
        if self.marker_is_column:
            key = group[spec][0]
            if key not in self.lc.markers:
                fresh = next((m for m in othermarkers if m not in self.used), None)
                self.lc.markers[key] = fresh if fresh is not None else next(itermarkers)
            return self.lc.markers[key]
        if spec in MarkerStyle.markers:
            return spec
        if spec == "none":
            return None
        return next(itermarkers)


def aux_axes(xfunc=None, yfunc=None, ax0=None, xfunc_args=None, yfunc_args=None):
    """Twin axes whose limits are transformations of the base axes
    (behavioral spec: reference lightcurve.py:691-735)."""
    import matplotlib.pyplot as plt
    ax0 = ax0 or plt.gca()
    left, right_lim, bottom, top_lim = ax0.axis()
    top = ax0
    right = None
    if xfunc is not None:
        ax0.xaxis.tick_bottom()
        left, right_lim = xfunc(np.array([left, right_lim]), **(xfunc_args or {}))
        top = ax0.twiny()
        top.axis((left, right_lim, bottom, top_lim))
    if yfunc is not None:
        ax0.yaxis.tick_left()
        bottom, top_lim = yfunc(np.array([bottom, top_lim]), **(yfunc_args or {}))
        right = top.twinx()
        right.axis((left, right_lim, bottom, top_lim))
    plt.sca(ax0)
    return top, right


# loc='above*' aliases -> (matplotlib loc, bbox anchor x)
_ABOVE_LOCS = {"above": ("lower center", 0.5),
               "above left": ("lower left", 0.0),
               "above right": ("lower right", 1.0)}


def custom_legend(ax, handles, labels, top_axis=True, **kwargs):
    """Legend supporting loc='above'/'above left'/'above right'
    (behavioral spec: reference lightcurve.py:738-783)."""
    import matplotlib.pyplot as plt
    loc = kwargs.pop("loc", None)
    bbox_to_anchor = kwargs.pop("bbox_to_anchor", None)
    if loc is None or loc.lower() == "none":
        return
    if loc in _ABOVE_LOCS:
        loc, anchor_x = _ABOVE_LOCS[loc]
        bbox_to_anchor = (anchor_x, 1.15 if top_axis else 1.0)
    ncol = kwargs.get("ncol")
    if ncol and len(handles) % ncol:
        # pad with a blank entry so columns stay aligned
        i = len(handles) // ncol
        handles.insert(i, plt.Line2D([], [], ls="none"))
        labels.insert(i, "")
    lgd = ax.legend(handles, labels, loc=loc, bbox_to_anchor=bbox_to_anchor, **kwargs)
    plt.tight_layout()
    return lgd


def filter_legend(filts, offset_factor=1.0):
    """Dummy artists + labels for the filter legend; sets arrange into a
    system-by-offset grid first (behavioral spec: reference
    lightcurve.py:786-828)."""
    from matplotlib.patches import Patch
    if isinstance(filts, set):
        filts = filtsetup(filts)
    elif isinstance(filts[0], str) or (isinstance(filts[0], list) and isinstance(filts[0][0], str)):
        filts = np.vectorize(filtdict.get)(filts)
    filts = np.asarray(filts, dtype=object)

    lines = []
    labels = []
    for filt in filts.flatten():
        if filt is None:
            labels.append("")
            lines.append(Patch(color="none", ec="none"))
            continue
        off = filt.offset * offset_factor
        if not filt.italics:
            labels.append(filt.name)
        elif offset_factor:
            labels.append("${}{:+g}$".format(filt.name, -off))
        else:
            labels.append("${}$".format(filt.name))
        lines.append(Patch(fc=filt.color, ec=filt.mec))
    return lines, labels, filts.shape[0]


def filtsetup(filts):
    """Arrange filters in a legend grid: photometric systems pack into rows
    (first-fit on disjoint offset sets) and offsets order the columns
    descending, duplicating a column when two systems collide on one offset
    (behavioral spec: reference lightcurve.py:831-875)."""
    # offsets used by each system, then first-fit systems into rows
    offsets_of = {}
    for filt in filts:
        offsets_of.setdefault(filt.system, set()).add(filt.offset)
    row_of = {}
    row_contents = []
    for system, used in offsets_of.items():
        slot = next((i for i, taken in enumerate(row_contents) if not taken & used), None)
        if slot is None:
            slot = len(row_contents)
            row_contents.append(set())
        row_contents[slot] |= used
        row_of[system] = slot

    # columns: offsets descending; collisions insert a duplicate column
    columns = sorted({filt.offset for filt in filts}, reverse=True)
    grid = np.tile(None, (len(row_contents), len(columns)))
    for filt in filts:
        r, c = row_of[filt.system], columns.index(filt.offset)
        if grid[r, c] is None:
            grid[r, c] = filt
        else:
            c += 1
            columns.insert(c, filt.offset)
            extra = np.tile(None, grid.shape[0])
            extra[r] = filt
            grid = np.insert(grid, c, extra, 1)
    while grid[0, 0] is None:
        grid = np.roll(grid, 1, axis=0)
    return grid


# --------------------------------------------------------------------------
# magnitude <-> flux conversion kernels
# --------------------------------------------------------------------------

_LN10_OVER_2P5 = np.log(10.0) / 2.5  # d(ln flux) per magnitude


def _as_float_masked(a):
    """Coerce to a float masked array (scalar inputs stay 0-d)."""
    if np.ndim(a):
        return np.ma.MaskedArray(a).astype(float)
    return np.float64(a)


def flux2mag(flux, dflux=np.array(np.nan), zp=0.0, nondet=None, nondetSigmas=3.0):
    """Flux -> magnitude; nondetections become N-sigma limiting magnitudes
    with undefined uncertainty (behavioral spec: reference
    lightcurve.py:878-909)."""
    flux = _as_float_masked(flux)
    dflux = _as_float_masked(dflux)
    if nondet is not None and np.ndim(flux):
        limits = np.ma.filled(np.ma.MaskedArray(nondet), False).astype(bool)
        flux = np.ma.where(limits, nondetSigmas * dflux, flux)
        dflux = np.ma.where(limits, np.nan, dflux)
    fdata = np.ma.filled(np.ma.MaskedArray(flux), np.nan)
    positive = fdata > 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        # the reference's log10 out=-inf fallback sits INSIDE the -2.5
        # multiply (reference lightcurve.py:908): nonpositive flux maps to
        # mag = +inf (infinitely faint)
        mag = np.where(positive, -2.5 * np.log10(np.where(positive, fdata, 1.0)), np.inf) + zp
        # masked uncertainties become NaN, not the fill value (a dmag of 0
        # would be infinite weight downstream)
        dmag = np.ma.filled(np.ma.MaskedArray(dflux), np.nan) / (fdata * _LN10_OVER_2P5)
    return mag, dmag


def mag2flux(mag, dmag=np.nan, zp=0.0, nondet=None, nondetSigmas=3.0):
    """Magnitude -> flux; nondetections imply zero flux with
    dflux = limit flux / N sigma (behavioral spec: reference
    lightcurve.py:912-941)."""
    mag_arr = np.ma.filled(np.ma.MaskedArray(mag).astype(float), np.nan)
    dmag_arr = np.ma.filled(np.ma.MaskedArray(dmag).astype(float), np.nan)
    flux = 10.0 ** ((np.asarray(zp) - mag_arr) / 2.5)
    dflux = flux * dmag_arr * _LN10_OVER_2P5
    if nondet is not None and np.ndim(flux):
        limits = np.ma.filled(np.ma.MaskedArray(nondet), False).astype(bool)
        dflux = np.where(limits, flux / nondetSigmas, dflux)
        flux = np.where(limits, 0.0, flux)
    return flux, dflux


# --------------------------------------------------------------------------
# greedy inverse-variance binning
# --------------------------------------------------------------------------

# error-bar values treated as "no uncertainty available"
_SENTINEL_DFLUX = (0.0, 999.0, 9999.0, -1.0)


def _seeded_groups(time, delta):
    """Greedy seed grouping: walk points in order; each not-yet-grouped point
    seeds a bin collecting every remaining point within ``delta`` of it.
    Yields index arrays in seed order (equivalent to the reference's
    repeated pop-the-front loop, lightcurve.py:944-1000)."""
    n = len(time)
    label = np.full(n, -1)
    groups = []
    for i in range(n):
        if label[i] >= 0:
            continue
        members = np.flatnonzero((label < 0) & np.asarray(np.abs(time - time[i]) <= delta))
        label[members] = len(groups)
        groups.append(members)
    return groups


def _merge_bin(time, flux, dflux, include_zero):
    """Combine one bin: inverse-variance mean, or a plain mean with zero
    error when any member lacks an error bar and include_zero is set."""
    no_error = np.isin(np.ma.filled(dflux, np.nan), _SENTINEL_DFLUX) \
        | np.isnan(np.ma.filled(dflux, np.nan))
    no_error = np.ma.filled(no_error, True) | np.ma.getmaskarray(dflux)

    if no_error.any() and include_zero:
        return np.mean(time), np.mean(flux), 0.0
    good = ~no_error
    weights = np.ma.filled(dflux[good], np.inf) ** -2
    wsum = weights.sum()
    return np.mean(time[good]), float(np.sum(flux[good] * weights) / wsum), float(wsum ** -0.5)


def binflux(time, flux, dflux, delta=0.2, include_zero=True):
    """Greedy inverse-variance binning (behavioral spec: reference
    lightcurve.py:944-1000, including the zero/masked error-bar handling at
    lines 972-988).

    Dispatches to the native C++ kernel (utils/native) when available; the
    numpy path below is the semantic spec and the fallback."""
    time = np.ma.MaskedArray(time).astype(float)
    flux = np.ma.MaskedArray(flux).astype(float)
    dflux = np.ma.MaskedArray(dflux).astype(float)

    if not (np.ma.getmaskarray(time).any() or np.ma.getmaskarray(flux).any()):
        from .utils import native
        d = np.ma.filled(dflux, np.nan)
        bad = np.isin(d, _SENTINEL_DFLUX) | np.isnan(d) | np.ma.getmaskarray(dflux)
        result = native.binflux_native(np.ma.getdata(time), np.ma.getdata(flux),
                                       np.where(bad, 1.0, d), bad, delta, include_zero)
        if result is not None:
            return result

    bins = [_merge_bin(time[idx], flux[idx], dflux[idx], include_zero)
            for idx in _seeded_groups(time, delta)]
    if not bins:
        return np.array([]), np.array([]), np.array([])
    out_t, out_f, out_df = zip(*bins)
    return np.array(out_t), np.array(out_f), np.array(out_df)
