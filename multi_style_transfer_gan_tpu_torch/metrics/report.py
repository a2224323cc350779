"""Reporting: Excel workbooks and bar-chart PNGs (a copy of the JAX
package's ``metrics/report.py``, which has no framework dependency; the
port keeps its own so that it imports nothing of that package).

The reference exports comparison results to .xlsx via pandas/openpyxl
(compare_image_quality.py:380-391, complete_comparison.py Excel styling) and
matplotlib bar charts (create_comparison_charts, :394-467). ``write_xlsx``
is a dependency-free minimal OOXML writer (xlsx = zip of XML parts; numbers
and inline strings are all the reports need). Output opens in
Excel/LibreOffice/pandas. ``comparison_bar_chart`` needs matplotlib.
"""

from __future__ import annotations

import os
import zipfile
from typing import Mapping, Sequence

_CT = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
{sheet_overrides}
</Types>"""

_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>"""

_WB = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">
<sheets>{sheets}</sheets>
</workbook>"""

_WB_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
{rels}
</Relationships>"""


def _esc(s: str) -> str:
    return (str(s).replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;").replace('"', "&quot;"))


def _cell(ref: str, value) -> str:
    if value is None:
        return ""
    # numpy scalars must become plain python numbers: repr(np.float64(x))
    # under numpy>=2 is "np.float64(x)" which corrupts the <v> cell, and
    # np.float32/np.int64 fail the isinstance checks entirely
    if hasattr(value, "item") and not hasattr(value, "__len__"):
        value = value.item()
    if isinstance(value, bool):
        return f'<c r="{ref}" t="b"><v>{int(value)}</v></c>'
    if isinstance(value, (int, float)):
        if value != value or value in (float("inf"), float("-inf")):
            return f'<c r="{ref}" t="inlineStr"><is><t>{value}</t></is></c>'
        return f'<c r="{ref}"><v>{value!r}</v></c>'
    return (f'<c r="{ref}" t="inlineStr"><is>'
            f'<t xml:space="preserve">{_esc(value)}</t></is></c>')


def _col_name(idx: int) -> str:
    name = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        name = chr(65 + rem) + name
    return name


def _sheet_xml(rows: Sequence[Sequence]) -> str:
    parts = ['<?xml version="1.0" encoding="UTF-8" standalone="yes"?>',
             '<worksheet xmlns="http://schemas.openxmlformats.org/'
             'spreadsheetml/2006/main"><sheetData>']
    for r, row in enumerate(rows, start=1):
        cells = "".join(_cell(f"{_col_name(c)}{r}", v)
                        for c, v in enumerate(row))
        parts.append(f'<row r="{r}">{cells}</row>')
    parts.append("</sheetData></worksheet>")
    return "".join(parts)


def write_xlsx(path, sheets: Mapping[str, Sequence[Sequence]]):
    """Write {sheet_name: rows} to an .xlsx. Rows are sequences of
    str/int/float/None. A pandas DataFrame can be passed too (converted
    with header row, like df.to_excel(index=False))."""
    norm = {}
    for name, rows in sheets.items():
        if hasattr(rows, "itertuples"):  # DataFrame
            df = rows
            norm[name] = [list(df.columns)] + df.values.tolist()
        else:
            norm[name] = [list(r) for r in rows]

    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    names = list(norm)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CT.format(sheet_overrides="".join(
            f'<Override PartName="/xl/worksheets/sheet{i+1}.xml" '
            f'ContentType="application/vnd.openxmlformats-officedocument.'
            f'spreadsheetml.worksheet+xml"/>' for i in range(len(names)))))
        z.writestr("_rels/.rels", _RELS)
        z.writestr("xl/workbook.xml", _WB.format(sheets="".join(
            f'<sheet name="{_esc(n)}" sheetId="{i+1}" r:id="rId{i+1}"/>'
            for i, n in enumerate(names))))
        z.writestr("xl/_rels/workbook.xml.rels", _WB_RELS.format(rels="".join(
            f'<Relationship Id="rId{i+1}" Type="http://schemas.openxmlformats'
            f'.org/officeDocument/2006/relationships/worksheet" '
            f'Target="worksheets/sheet{i+1}.xml"/>'
            for i in range(len(names)))))
        for i, n in enumerate(names):
            z.writestr(f"xl/worksheets/sheet{i+1}.xml", _sheet_xml(norm[n]))


def comparison_bar_chart(path, labels, series: Mapping[str, Sequence[float]],
                         title: str, ylabel: str):
    """Grouped bar chart PNG like create_comparison_charts
    (compare_image_quality.py:394-467). Host-side matplotlib, or PIL where
    matplotlib is not installed (``utils.figures``)."""
    from ..utils.figures import bar_chart, have_matplotlib

    if not have_matplotlib():
        bar_chart(path, labels, series, title, ylabel)
        return
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    x = np.arange(len(labels))
    n = max(len(series), 1)
    width = 0.8 / n
    fig, ax = plt.subplots(figsize=(max(6, len(labels) * 1.2), 5))
    for i, (name, vals) in enumerate(series.items()):
        ax.bar(x + (i - (n - 1) / 2) * width, vals, width, label=name)
    ax.set_xticks(x)
    ax.set_xticklabels(labels, rotation=30, ha="right")
    ax.set_title(title)
    ax.set_ylabel(ylabel)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
