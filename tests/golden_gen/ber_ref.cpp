// BER-parity harness: drives the REFERENCE RX chain (compiled in place
// from /root/reference/m17gismo -- timing recovery m17_rx_sync.cpp,
// framer m17_rx_frame.cpp, frame decode m17_rx_parse.cpp, FEC
// m17_conv/golay/puncture/interleave/correlate/crc) over pre-generated
// noisy 2-samples/symbol baseband waveforms, and prints every decoded
// stream payload.  The SAME waveform file is decoded by the JAX chain
// (m17_sdr/pipeline/ber_parity.py), so per-SNR BER agreement is a
// direct implementation comparison, not a statistical coincidence of
// separate noise draws.
//
// Input (argv[1]), little-endian binary:
//   int32 nch, int32 nsamp          -- channels, samples per channel
//   float32 data[nch][nsamp]        -- 2 samples/symbol soft baseband
// Output (stdout): one line per decoded stream payload:
//   P <ch> <fn> <32 hex chars of the 16 payload bytes>

#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "m17defines.h"

// ---- stubs for the control-plane symbols the RX chain calls ----
static int g_ch = -1;
static uint16_t g_fn = 0;

void gui_update(void) {}
void gui_save_dest_address(uint48_t a) { (void)a; }
void gui_save_src_address(uint48_t a) { (void)a; }
void radio_afc(float mean) { (void)mean; }
float radio_get_afc_delta(void) { return 0.0f; }
bool radio_get_afc_status(void) { return false; }

// minimal database: DRTOAS so decode_stream_frame routes payloads via
// sound_data_received -> m17_txrx_spkr_audio (m17_rx_parse.cpp:26-32,
// 148-159)
static M17_Dbase g_db;
const M17_Dbase *m17_get_db(void) { return &g_db; }
CircuitType m17_db_get_chan_type(void) { return DRTOAS; }
void m17_db_golay_errors(uint16_t e) { (void)e; }
void m17_db_stream_seq_number(uint16_t n) { g_fn = n; }
void m17_db_set_rx_src(uint48_t a) { (void)a; }
void m17_db_set_rx_dst(uint48_t a) { (void)a; }
bool m17_db_is_for_me(uint48_t a) { (void)a; return true; }
void m17_aos(void) {}
void m17_los(void) {}
bool m17_net_new_rx_data(uint16_t id, uint8_t *lich, uint16_t fn,
                         uint8_t *pld) {
    (void)id; (void)lich; (void)fn; (void)pld; return true;
}

// payload capture: decode_stream_frame delivers the 16-byte payload as
// two 8-byte codec blocks; reassemble and print one line per frame.
static uint8_t g_half[8];
static int g_halves = 0;
void m17_txrx_spkr_audio(uint8_t *data) {
    if (g_halves == 0) {
        memcpy(g_half, data, 8);
        g_halves = 1;
        return;
    }
    printf("P %d %u ", g_ch, (unsigned)g_fn);
    for (int i = 0; i < 8; i++) printf("%02x", g_half[i]);
    for (int i = 0; i < 8; i++) printf("%02x", data[i]);
    printf("\n");
    g_halves = 0;
}

// ---- packet/BERT frame scoring (round 4) ----
// m17_rx_parse dispatches packet frames into parse_packet (a same-TU
// static chain ending in the EMPTY valid_packet_received hook,
// m17_rx_parse.cpp:16-17) and BERT frames into the EMPTY
// decode_bert_frame stub (m17_rx_parse.cpp:178-180) -- neither path
// surfaces decoded bits.  The framer's call into m17_rx_parse IS
// cross-TU (m17_rx_frame.cpp:142), so the linker's --wrap intercepts
// every classified frame: packet frames are decoded per-frame exactly
// as decode_packet_frame does (m17_rx_parse.cpp:161-177) and printed
// as K-lines, and BERT frames are decoded the way the reference's TX
// format defines (m17_fmt_add_bert_frame, m17_tx_routines.cpp:226-238:
// 197 PRBS bits + 4-bit tail -> conv -> P2 puncture) using the
// REFERENCE's own de-correlate/interleave/puncture/Viterbi components,
// completing the stub the reference never finished, printed as
// B-lines.  Control then continues into the real m17_rx_parse so
// stream/LSF behavior is untouched.
extern "C" void __real__Z12m17_rx_parsePfh(float *s, uint8_t type);
extern "C" void __wrap__Z12m17_rx_parsePfh(float *s, uint8_t type) {
    if (type == 3) {                       // packet frame
        float sb[384], so[2][420];
        uint8_t bits[424], bytes[240];
        m17_dsp_demap_frame(s, sb);
        m17_de_correlate_1(sb, sb, 368);
        m17_de_interleave(sb, so[0], 368);
        m17_de_punc_p3(so[0], so[1], 420);
        m17_viterbi_decode(so[1], bits, 420);
        pack_1_to_8(&bits[1], bytes, 208);
        uint8_t eof = bytes[25] >> 7;
        uint8_t fn = (bytes[25] >> 2) & 0x1F;
        printf("K %d %u %u ", g_ch, (unsigned)fn, (unsigned)eof);
        for (int i = 0; i < 25; i++) printf("%02x", bytes[i]);
        printf("\n");
    } else if (type == 4) {                // BERT frame
        float sb[384], so[2][420];
        uint8_t bits[424], bytes[32];
        m17_dsp_demap_frame(s, sb);
        m17_de_correlate_1(sb, sb, 368);
        m17_de_interleave(sb, so[0], 368);
        // the BERT TX puncture emits 369 bits but the frame carries
        // 368 (m17_fmt_add_bert_frame interleaves only 368,
        // m17_tx_routines.cpp:233-236), so de_punc_p2(402) consumes
        // one soft value past the frame: feed it a 0.0 erasure
        so[0][368] = 0.0f;
        m17_de_punc_p2(so[0], so[1], 402);
        m17_viterbi_decode(so[1], bits, 402);
        memset(bytes, 0, sizeof(bytes));
        // the reference Viterbi's first output bit is a dummy -- its
        // packet path reads from &bits[1] ("Discard 2 tail bits",
        // m17_rx_parse.cpp:171-172); same here
        pack_1_to_8(&bits[1], bytes, 200);  // 197 PRBS bits + 3 pad
        printf("B %d ", g_ch);
        for (int i = 0; i < 25; i++) printf("%02x", bytes[i]);
        printf("\n");
    }
    __real__Z12m17_rx_parsePfh(s, type);
}

int main(int argc, char **argv) {
    if (argc < 2) { fprintf(stderr, "usage: ber_ref <waveform.bin>\n"); return 2; }
    FILE *f = fopen(argv[1], "rb");
    if (!f) { perror("open"); return 2; }
    int32_t nch = 0, nsamp = 0;
    if (fread(&nch, 4, 1, f) != 1 || fread(&nsamp, 4, 1, f) != 1) return 2;

    m17_dsp_init();
    m17_init_conv();
    m17_golay_init();
    m17_crc_init();
    m17_init_de_correlate();

    float *buf = (float *)malloc(sizeof(float) * nsamp);
    // m17_sync_adjust's backward bit-slip decrements the output index
    // before anything was emitted (m17_rx_sync.cpp:66-69), so a chunk
    // can write out[-1]; pad so the reference's latent underflow can't
    // corrupt the heap (its own callers pass stack arrays and absorb it)
    float *tmp0 = (float *)malloc(sizeof(float) * (nsamp + 128));
    float *tmp = tmp0 + 64;
    const int CHUNK = 384;  // block size m17_dsp_rx feeds the timing loop
    for (int c = 0; c < nch; c++) {
        g_ch = c;
        // fresh timing/framer state per channel: re-init the polyphase
        // loop; the framer returns to hunt via the EOT/LOS at session
        // end plus the trailing guard silence in the waveform.
        m17_rx_sync_init();
        if (fread(buf, sizeof(float), nsamp, f) != (size_t)nsamp) return 2;
        for (int pos = 0; pos + CHUNK <= nsamp; pos += CHUNK) {
            int n = m17_rx_sync_samples(&buf[pos], tmp, CHUNK);
            m17_rx_symbols(tmp, n);
        }
    }
    free(buf); free(tmp0);
    fclose(f);
    return 0;
}
