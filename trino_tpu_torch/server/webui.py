"""Coordinator web UI: a single-file query monitor.

Counterpart of trino_tpu/server/webui.py (copied).

Reference parity: core/trino-main/src/main/resources/webapp/ — the React
cluster/query UI served by the coordinator.  This engine serves one
dependency-free HTML page at /ui that polls the same REST endpoints the
reference UI uses (/v1/status, /v1/query, /v1/query/{id}) and renders the
cluster summary, the query list, per-query task statistics, the
per-tenant SLO panel (/v1/slo), and the top-10 plan signatures with
their warmest node (/v1/signatures).
"""

UI_HTML = """<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>trino-tpu</title>
<style>
  body { font-family: ui-sans-serif, system-ui, sans-serif; margin: 0;
         background: #0f1318; color: #e6e9ed; }
  header { padding: 14px 24px; background: #161c24;
           border-bottom: 1px solid #2a3340; display: flex; gap: 24px;
           align-items: baseline; }
  h1 { font-size: 16px; margin: 0; color: #7fd1b9; }
  .stat { font-size: 13px; color: #9aa7b4; }
  .stat b { color: #e6e9ed; }
  main { padding: 18px 24px; }
  table { border-collapse: collapse; width: 100%; font-size: 13px; }
  th, td { text-align: left; padding: 6px 10px;
           border-bottom: 1px solid #222b36; }
  th { color: #9aa7b4; font-weight: 600; }
  tr.q { cursor: pointer; }
  tr.q:hover { background: #19212b; }
  .FINISHED { color: #7fd1b9; } .FAILED { color: #e0707a; }
  .RUNNING, .PLANNING, .QUEUED { color: #e3c567; }
  #detail { margin-top: 18px; padding: 12px; background: #161c24;
            border: 1px solid #2a3340; border-radius: 6px;
            white-space: pre-wrap; font-family: ui-monospace, monospace;
            font-size: 12px; display: none; }
  h2 { font-size: 13px; color: #9aa7b4; margin: 22px 0 6px; }
  .burn-ok { color: #7fd1b9; } .burn-hot { color: #e0707a; }
</style>
</head>
<body>
<header>
  <h1>trino-tpu</h1>
  <span class="stat">workers <b id="workers">–</b></span>
  <span class="stat">queries <b id="nqueries">–</b></span>
  <span class="stat">uptime <b id="uptime">–</b></span>
</header>
<main>
  <table>
    <thead><tr><th>query id</th><th>state</th><th>query</th>
               <th>error</th></tr></thead>
    <tbody id="rows"></tbody>
  </table>
  <div id="detail"></div>
  <h2>tenant SLOs</h2>
  <table>
    <thead><tr><th>tenant</th><th>target</th><th>budget</th>
               <th>fast burn</th><th>slow burn</th><th>violations</th>
               <th>burn events</th><th>p99</th></tr></thead>
    <tbody id="slorows"></tbody>
  </table>
  <h2>top signatures</h2>
  <table>
    <thead><tr><th>signature</th><th>tenant</th><th>count</th>
               <th>rate/s</th><th>p99</th><th>drift</th>
               <th>cache h/m</th><th>warmest node</th></tr></thead>
    <tbody id="sigrows"></tbody>
  </table>
</main>
<script>
async function j(u) { const r = await fetch(u); return r.json(); }
async function refresh() {
  try {
    const st = await j('/v1/status');
    document.getElementById('workers').textContent =
      st.activeWorkers ?? st.workers ?? '–';
    document.getElementById('uptime').textContent =
      st.uptimeSeconds ? st.uptimeSeconds.toFixed(0) + 's' : '–';
    const qs = await j('/v1/query');
    document.getElementById('nqueries').textContent = qs.length;
    const tbody = document.getElementById('rows');
    tbody.innerHTML = '';
    for (const q of qs.slice().reverse()) {
      const tr = document.createElement('tr');
      tr.className = 'q';
      for (const [text, cls] of [[q.queryId, null], [q.state, q.state],
                                 [q.query || '', null], [q.error || '', null]]) {
        const td = document.createElement('td');
        td.textContent = text;
        if (cls) td.className = cls;
        tr.appendChild(td);
      }
      tr.onclick = async () => {
        const d = await j('/v1/query/' + q.queryId);
        let prof = null;
        try { prof = await j('/v1/query/' + q.queryId + '/profile'); }
        catch (e) { /* profile unavailable */ }
        const el = document.getElementById('detail');
        el.style.display = 'block';
        let text = JSON.stringify(d, null, 2);
        const s = prof && prof.summary;
        if (s && Object.keys(s).length) {
          text += '\\n\\nTPU kernel profile:' +
            '\\n  compile wall: ' + (s.compileWallS * 1000).toFixed(2) + 'ms' +
            '\\n  compiles: ' + s.compiles + ' (recompiles ' + s.recompiles +
            ', cache hits ' + s.cacheHits + ')' +
            (s.compilesByCause && Object.keys(s.compilesByCause).length
              ? '\\n  by cause: ' + Object.entries(s.compilesByCause)
                  .filter(([, n]) => n > 0)
                  .map(([c, n]) => c + '=' + n).join(', ')
              : '') +
            '\\n  padding ratio: ' + s.paddingRatio.toFixed(2) + 'x (' +
            s.actualRows + ' -> ' + s.paddedRows + ' rows)' +
            '\\n  transfers: ~' + s.h2dBytes + 'B h2d, ~' + s.d2hBytes + 'B d2h';
        }
        el.textContent = text;
      };
      tbody.appendChild(tr);
    }
  } catch (e) { /* coordinator restarting */ }
  try {
    const slo = await j('/v1/slo');
    const sb = document.getElementById('slorows');
    sb.innerHTML = '';
    for (const t of slo.slos || []) {
      const tr = document.createElement('tr');
      const burn = (v) => {
        const td = document.createElement('td');
        td.textContent = v.toFixed(2) + 'x';
        td.className = v > 1.0 ? 'burn-hot' : 'burn-ok';
        return td;
      };
      const cell = (v) => {
        const td = document.createElement('td');
        td.textContent = v;
        return td;
      };
      tr.appendChild(cell(t.tenant));
      tr.appendChild(cell(t.latencyTargetS.toFixed(2) + 's'));
      tr.appendChild(cell((t.errorBudget * 100).toFixed(0) + '%'));
      tr.appendChild(burn(t.fastBurnRate));
      tr.appendChild(burn(t.slowBurnRate));
      tr.appendChild(cell(t.violationsTotal + '/' + t.observedTotal));
      tr.appendChild(cell(t.burnEvents));
      tr.appendChild(cell((t.p99S * 1000).toFixed(0) + 'ms'));
      sb.appendChild(tr);
    }
    const sigs = await j('/v1/signatures');
    const gb = document.getElementById('sigrows');
    gb.innerHTML = '';
    for (const s of sigs.top || []) {
      const tr = document.createElement('tr');
      for (const v of [s.signature.slice(0, 12), s.tenant, s.count,
                       s.ratePerS.toFixed(2), (s.p99S * 1000).toFixed(0) + 'ms',
                       s.driftRatio.toFixed(1) + 'x',
                       s.cacheHits + '/' + s.cacheMisses,
                       s.warmestNode || '–']) {
        const td = document.createElement('td');
        td.textContent = v;
        tr.appendChild(td);
      }
      gb.appendChild(tr);
    }
  } catch (e) { /* observatory not up yet */ }
}
refresh(); setInterval(refresh, 2000);
</script>
</body>
</html>
"""
